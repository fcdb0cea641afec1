"""Whole-volume segmentation with every buffer on the device.

Port of ``skoots_tpu/infer/device_pipeline.py::make_chunked_pipeline``
(:274-509) with its fg-compacted assignment (``make_compact_assign_tile``,
:177-245):

    volume [X, Y, Z] -> instance labels [X, Y, Z] int32, on the device

1. forward: normalise, reflect-pad by the overlap, run the model over a
   static tile grid; per tile, gate vectors and skeleton by ``prob > thr``,
   dilate the skeleton (3D then in-plane passes) and store the interiors:
   bf16 vectors and one mask byte (bit 0 dilated skeleton, bit 1 semantic
   foreground);
2. connected components of bit 0 (``ops/flood_fill.py``);
3. assignment over a second tile grid: walk the embedding N steps inside
   the tile (indices clamped to the tile) and gather the component label at
   the final position in the whole volume, gated by bit 1.

PyTorch runs eagerly, so where the JAX package chunks jitted dispatches the
port simply loops; phase timings synchronise the device at the phase ends.
"""

from __future__ import annotations

import os
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from skoots_tpu_torch.ops.cropper import crop_origins
from skoots_tpu_torch.ops.flood_fill import make_label_components_stepped
from skoots_tpu_torch.ops.morphology import binary_dilation, binary_dilation_2d
from skoots_tpu_torch.ops.vec2embed import fma, vector_to_embedding
from skoots_tpu_torch.utils.device import resolve_device


def _round4(d: int) -> int:
    return max(4, (d // 4) * 4)


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of ``np.pad(..., mode='reflect')`` along one axis."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def reflect_pad(vol: torch.Tensor, pads) -> torch.Tensor:
    """Reflect-pad the three leading axes (``np.pad`` 'reflect' semantics)."""
    for ax, (lo, hi) in enumerate(pads):
        if lo or hi:
            vol = vol.index_select(
                ax, _reflect_index(vol.shape[ax], lo, hi, vol.device))
    return vol


def tile_masks(out: torch.Tensor, prob_threshold: float, sem_thr: float,
               dilation_3d: int, dilation_2d: int):
    """Per-tile phase-1 decisions from the model output ``[..., X, Y, Z, 5]``:
    (gated vectors f32 ``[..., 3]``, dilated-skeleton mask uint8, semantic
    mask uint8), each mask ``[..., X, Y, Z]``."""
    vec = out[..., 0:3]
    skel = out[..., 3:4]
    prob = out[..., 4:5]
    keep = (prob > prob_threshold).to(out.dtype)
    s = skel * keep
    for _ in range(dilation_3d):
        s = binary_dilation(s)
    for _ in range(dilation_2d):
        s = binary_dilation_2d(s)
    skel_u8 = (s[..., 0] > prob_threshold).to(torch.uint8)
    sem_u8 = (prob[..., 0] > sem_thr).to(torch.uint8)
    return vec * keep, skel_u8, sem_u8


def make_compact_assign_tile(a_crop, volume_shape, scale, n: int,
                             decay: float, device):
    """Assignment of one tile walking only its foreground voxels.

    Background voxels of the gated output are 0 wherever their walk lands,
    so only the fg voxels walk: N-1 steps inside the tile (indices clamped
    to the tile), then the final rounded position plus the tile origin,
    clamped to the volume, picks the label. Output-exact against the dense
    gated walk. Returns ``assign(vtile f32 [ax, ay, az, 3], fg bool
    [ax, ay, az], labels int32 [X, Y, Z], origin) -> int32 tile``."""
    ax, ay, az = a_crop
    x, y, z = volume_shape
    sizes = torch.tensor(a_crop, dtype=torch.int64, device=device)
    strides = torch.tensor([ay * az, az, 1], dtype=torch.int64, device=device)
    scale_v = torch.as_tensor(scale, dtype=torch.float32, device=device).view(1, 3)

    def assign(vtile, fg, labels, o):
        flat_vec = vtile.reshape(-1, 3)
        sel = torch.nonzero(fg.reshape(-1)).squeeze(1)
        r = sel % (ay * az)
        coord = torch.stack([sel // (ay * az), r // az, r % az], -1).float()
        cur = fma(flat_vec[sel], scale_v, coord)
        step = 1.0
        for _ in range(n - 1):
            step = step * decay
            idx = torch.round(cur).to(torch.int64).clamp(
                min=torch.zeros_like(sizes), max=sizes - 1)
            cur = fma(flat_vec[(idx * strides).sum(-1)], scale_v * step, cur)
        g = torch.round(cur).to(torch.int64) + torch.as_tensor(o, device=device)
        vals = labels[g[:, 0].clamp(0, x - 1), g[:, 1].clamp(0, y - 1),
                      g[:, 2].clamp(0, z - 1)]
        tile = torch.zeros(ax * ay * az, dtype=labels.dtype, device=device)
        tile[sel] = vals
        return tile.view(ax, ay, az)

    return assign


def make_chunked_pipeline(
    model,
    volume_shape: Tuple[int, int, int],
    crop: Tuple[int, int, int] = (128, 128, 64),
    overlap: Tuple[int, int, int] = (16, 16, 8),
    assign_crop: Tuple[int, int, int] | None = (256, 256, 64),
    vector_scale: Sequence[float] = (60.0, 60.0, 12.0),
    prob_threshold: float = 0.8,
    embed_iterations: int = 10,
    embed_decay: float = 1.0,
    embed_exit_fraction: float | None = None,
    embed_exit_cycle: bool = False,
    embed_compact_div: int | None = None,
    dilation_3d: int = 1,
    dilation_2d: int = 2,
    semantic_threshold: float | None = None,
    semantic_gate: bool = True,
    cc_rounds: int = 32,
    cc_propagates_per_round: int = 128,
    cc_jumps_per_round: int = 1,
    cc_scans_per_round: int = 0,
    cc_impl: str = "auto",
    tiles_per_dispatch: int = 16,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
):
    """Build ``run(volume, mean, std) -> int32 instance labels [X, Y, Z]``
    (on ``device``, by default the first CUDA card; asking for CUDA without
    one raises) for one volume shape; ``model`` is the port's
    ``SpatialEmbedding`` on that device.

    Knobs are the JAX package's. ``embed_compact_div`` (with the semantic
    gate) selects the fg-compacted assignment; torch's ``nonzero`` needs no
    capacity, so its value only switches the path on. ``tiles_per_dispatch``
    is accepted for signature parity: eager PyTorch has no compiled
    dispatch to chunk. ``run.last_phase_s`` holds the phase split of the
    last call, ``run.last_cc_rounds`` / ``run.last_cc_converged`` the CC
    telemetry.
    """
    device = resolve_device(device)
    cc_impl = os.environ.get("SKOOTS_CC_IMPL", cc_impl)
    if cc_impl not in ("auto", "dense"):
        raise NotImplementedError(
            f"cc_impl {cc_impl!r}: only the dense propagate engine is ported "
            "(see ROADMAP.md)")
    x, y, z = volume_shape
    crop = tuple(min(c, _round4(d)) for c, d in zip(crop, volume_shape))
    ov = tuple(min(o, c // 4) for o, c in zip(overlap, crop))
    pads = [(o, max(o, c - (d + o))) for d, c, o in zip(volume_shape, crop, ov)]
    px, py, pz = (d + p[0] + p[1] for d, p in zip((x, y, z), pads))
    origins = crop_origins((px, py, pz), crop, ov)
    cx, cy, cz = crop
    interior = tuple(slice(o, c - o) for o, c in zip(ov, crop))
    sem_thr = prob_threshold if semantic_threshold is None else semantic_threshold

    stepped_cc = make_label_components_stepped(
        (x, y, z), rounds_per_dispatch=1,
        propagates_per_round=cc_propagates_per_round,
        jumps_per_round=cc_jumps_per_round,
        scans_per_round=cc_scans_per_round,
    )

    a_crop = tuple(min(c, _round4(d))
                   for c, d in zip(assign_crop or crop, volume_shape))
    a_origins = crop_origins((x, y, z), a_crop, (0, 0, 0))
    compact_assign = (
        make_compact_assign_tile(a_crop, (x, y, z), vector_scale,
                                 embed_iterations, embed_decay, device)
        if (embed_compact_div and semantic_gate) else None
    )

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @torch.no_grad()
    def run(volume, mean, std):
        timing = os.environ.get("SKOOTS_PHASE_TIMING")
        run.last_phase_s = {}
        sync()
        t0 = time.time()

        def mark(tag):
            nonlocal t0
            sync()
            t1 = time.time()
            run.last_phase_s[tag] = round(t1 - t0, 3)
            if timing:
                print(f"# phase {tag}: {t1 - t0:.2f}s", flush=True)
            t0 = t1

        if not torch.is_tensor(volume):
            volume = torch.from_numpy(np.ascontiguousarray(volume))
        vol = volume.to(device)
        vol = reflect_pad((vol.float() - float(mean)) / float(std), pads)
        vec_buf = torch.zeros((px, py, pz, 3), dtype=dtype, device=device)
        skel_buf = torch.zeros((px, py, pz), dtype=torch.uint8, device=device)
        for o in origins:
            tile = vol[o[0]:o[0] + cx, o[1]:o[1] + cy, o[2]:o[2] + cz]
            out = model(tile[None, ..., None])[0]
            vec, skel_u8, sem_u8 = tile_masks(out, prob_threshold, sem_thr,
                                              dilation_3d, dilation_2d)
            dst = tuple(slice(oo + s.start, oo + s.stop)
                        for oo, s in zip(o, interior))
            vec_buf[dst] = vec[interior].to(dtype)
            skel_buf[dst] = (skel_u8 | (sem_u8 << 1))[interior]
        mark("1-forward")
        del vol
        trim = tuple(slice(p[0], p[0] + d) for p, d in zip(pads, (x, y, z)))
        vec_full = vec_buf[trim]
        skel_full = skel_buf[trim]

        labels = stepped_cc(skel_full & 1, max_rounds=cc_rounds)
        run.last_cc_impl = "dense"
        run.last_cc_rounds = stepped_cc.last_rounds
        run.last_cc_converged = stepped_cc.last_converged
        mark("2-cc")

        inst = torch.zeros((x, y, z), dtype=torch.int32, device=device)
        for o in a_origins:
            sl = tuple(slice(oo, oo + c) for oo, c in zip(o, a_crop))
            vtile = vec_full[sl].float()
            fg = (skel_full[sl] >> 1) > 0
            if compact_assign is not None:
                inst[sl] = compact_assign(vtile, fg, labels, o)
                continue
            emb = vector_to_embedding(
                vector_scale, vtile[None], n=embed_iterations,
                decay=embed_decay, exit_fraction=embed_exit_fraction,
                exit_cycle=embed_exit_cycle, compact_div=embed_compact_div)[0]
            emb = emb + torch.tensor(o, dtype=torch.float32, device=device)
            idx = torch.round(emb).to(torch.int64)
            tile_inst = labels[idx[..., 0].clamp(0, x - 1),
                               idx[..., 1].clamp(0, y - 1),
                               idx[..., 2].clamp(0, z - 1)]
            if semantic_gate:
                tile_inst = torch.where(fg, tile_inst, 0)
            inst[sl] = tile_inst
        mark("3-assign")
        return inst

    run.last_phase_s = {}
    run.last_cc_impl = None
    run.last_cc_rounds = None
    run.last_cc_converged = None
    return run


def estimated_device_bytes(volume_shape, thrifty: bool = False) -> int:
    """Peak device memory of :func:`make_chunked_pipeline`, conservatively:
    the padded f32 volume (4 B/vox), bf16 vectors (6) and the mask byte (1)
    in phase 1; int32 labels, CC ping-pong buffers and int32 instances in
    phases 2-3 -- 24 B/vox covers the worse phase with headroom. With
    ``thrifty``, the JAX package's estimate for its HBM-thrifty pipeline
    (uint8 volume, mask, CC working set: 13 B/vox), which the port does not
    have yet."""
    x, y, z = volume_shape
    return int(x) * int(y) * int(z) * (13 if thrifty else 24)
