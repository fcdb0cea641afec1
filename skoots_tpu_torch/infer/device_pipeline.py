"""Whole-volume segmentation with every buffer on the device.

Port of ``skoots_tpu/infer/device_pipeline.py``: the single-program
pipeline ``make_device_pipeline`` (:40-174), ``make_chunked_pipeline``
(:274-509) with its fg-compacted assignment (``make_compact_assign_tile``,
:177-245) and its wrapper ``segment_volume_chunked`` (:512), and the
device-thrifty variant ``make_thrifty_pipeline`` (:518-728):

    volume [X, Y, Z] -> instance labels [X, Y, Z] int32

1. forward: normalise, reflect-pad by the overlap, run the model over a
   static tile grid; per tile, gate vectors and skeleton by ``prob > thr``,
   dilate the skeleton (3D then in-plane passes) and store the interiors:
   bf16 vectors and one mask byte (bit 0 dilated skeleton, bit 1 semantic
   foreground);
2. connected components of bit 0 (``ops/flood_fill.py``);
3. assignment over a second tile grid: walk the embedding N steps inside
   the tile (indices clamped to the tile) and gather the component label at
   the final position in the whole volume, gated by bit 1.

The thrifty pipeline keeps the volume in its native dtype, holds no vector
buffer (phase 3 runs the forward again per assign tile) and compacts the
labels after CC, to 16 bits when the count fits.

PyTorch runs eagerly, so where the JAX package chunks jitted dispatches the
port simply loops; phase timings synchronise the device at the phase ends.
Each ``run()`` is the root span ``seg.block`` of ``utils/trace.py``, its
phases, forward tiles and allocator releases spans inside it.

On a card the instance mask comes back in page-locked host memory, whole:
each X-slab of it is copied on a stream of its own as soon as the last
assign tile that writes into it has been issued (:class:`_HostMask`), so
the copies overlap the tiles that remain.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from skoots_tpu_torch.ops.cropper import crop_origins
from skoots_tpu_torch.ops.flood_fill import (
    _compact_labels,
    _stepped_labeller,
    label_components_sparse,
    make_label_components_stepped,
    widen_u16,
)
from skoots_tpu_torch.ops.morphology import binary_dilation, binary_dilation_2d
from skoots_tpu_torch.ops.vec2embed import fma, vector_to_embedding
from skoots_tpu_torch.utils import trace
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


def normalized_reflect_pad(volume: torch.Tensor, mean: float, std: float, pads,
                           device) -> torch.Tensor:
    """``reflect_pad((volume.float() - mean) / std, pads)`` on ``device``,
    built in one f32 buffer: the normalised interior in place, then each
    axis's pads copied from it (axes before it already padded, the ones
    after it still their interior, as the chain of ``index_select`` does).
    The padded volume is the only f32 volume held; a whole-volume chain
    would leave each of its f32 intermediates in the allocator's cache."""
    src = trace.to_device(volume, device, "forward.volume_h2d")
    shape = tuple(src.shape)
    buf = torch.empty(tuple(d + lo + hi for d, (lo, hi) in zip(shape, pads)),
                      dtype=torch.float32, device=device)
    inner = tuple(slice(lo, lo + d) for d, (lo, _) in zip(shape, pads))
    buf[inner].copy_(src)
    del src
    buf[inner].sub_(float(mean)).div_(float(std))
    for ax, (lo, hi) in enumerate(pads):
        if not (lo or hi):
            continue
        view = buf[(slice(None),) * (ax + 1) + inner[ax + 1:]]
        src_idx = _reflect_index(shape[ax], lo, hi, device) + lo
        if lo:
            view.narrow(ax, 0, lo).copy_(view.index_select(ax, src_idx[:lo]))
        if hi:
            view.narrow(ax, lo + shape[ax], hi).copy_(
                view.index_select(ax, src_idx[lo + shape[ax]:]))
    return buf


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


def make_compact_assign_tile(a_crop, volume_shape, scale_arr, n: int,
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
    scale_v = torch.as_tensor(scale_arr, dtype=torch.float32, device=device).view(1, 3)

    def assign(vtile, fg, labels, o):
        flat_vec = vtile.reshape(-1, 3)
        trace.host_sync("assign.nonzero", device)
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
        trace.host_sync("assign.origin_h2d", device)
        g = torch.round(cur).to(torch.int64) + torch.as_tensor(o, device=device)
        vals = labels[g[:, 0].clamp(0, x - 1), g[:, 1].clamp(0, y - 1),
                      g[:, 2].clamp(0, z - 1)]
        tile = torch.zeros(ax * ay * az, dtype=labels.dtype, device=device)
        tile[sel] = vals
        return tile.view(ax, ay, az)

    return assign


def _tile_grid(volume_shape, crop, overlap):
    """The forward's static tile grid: (crop, reflect pads, padded shape,
    tile origins in padded coordinates, the tile interior)."""
    crop = tuple(min(c, _round4(d)) for c, d in zip(crop, volume_shape))
    ov = tuple(min(o, c // 4) for o, c in zip(overlap, crop))
    pads = [(o, max(o, c - (d + o))) for d, c, o in zip(volume_shape, crop, ov)]
    padded = tuple(d + p[0] + p[1] for d, p in zip(volume_shape, pads))
    interior = tuple(slice(o, c - o) for o, c in zip(ov, crop))
    return crop, pads, padded, crop_origins(padded, crop, ov), interior


def _phase_clock(run, device):
    """``run.last_phase_s``'s clock (:class:`~skoots_tpu_torch.utils.trace.PhaseClock`),
    synchronising ``device`` at each phase's end; the phases are the spans
    ``seg.<phase>``."""
    return trace.PhaseClock(
        run, "seg", lambda: trace.synchronize(device, "phase_clock.synchronize"))


def _assign_plan(volume_shape, assign_crop, vector_scale, n, decay,
                 compact: bool, device):
    """The assignment's tile grid (no overlap, no padding): (assign crop,
    origins, the fg-compacted assign of :func:`make_compact_assign_tile`
    when ``compact``, else None)."""
    a_crop = tuple(min(c, _round4(d)) for c, d in zip(assign_crop, volume_shape))
    a_origins = crop_origins(tuple(volume_shape), a_crop, (0, 0, 0))
    compact_assign = (make_compact_assign_tile(a_crop, volume_shape, vector_scale,
                                               n, decay, device)
                      if compact else None)
    return a_crop, a_origins, compact_assign


def mask_slabs(origins, crop, x: int):
    """The X-slabs of the assignment's output in the order they become
    final: ``[(after, x0, x1)]``, slab ``[x0, x1)`` written by no tile after
    index ``after`` of ``origins`` (tiles of extent ``crop``, in their
    order; later tiles overwrite earlier ones where they overlap). The
    slabs cover ``[0, x)``; a slab no tile writes has ``after`` -1."""
    last = np.full(x, -1)
    for i, o in enumerate(origins):
        last[o[0]:o[0] + crop[0]] = i
    cuts = [0, *(np.flatnonzero(np.diff(last)) + 1).tolist(), x]
    return sorted(((int(last[a]), a, b) for a, b in zip(cuts, cuts[1:])),
                  key=lambda s: s[0])


class _HostMask:
    """The instance mask's way to the host. On a card: a page-locked host
    mask of the device mask's shape and dtype, allocated per call (the
    caching host allocator reuses freed blocks, and a mask a caller keeps is
    never written again); after the assign tile of index ``i`` has been
    issued, :meth:`tile_done` copies each slab of :func:`mask_slabs` made
    final by it on the copy stream, behind an event of the compute stream,
    counted under ``mask_d2h`` as ``overlapped`` while tiles remain, else
    ``tail``; :meth:`result` waits for the last copy (the span
    ``seg.mask_d2h``, a ``host_sync`` at ``mask.d2h_wait``) and returns the
    host mask. Elsewhere the device mask itself, with nothing recorded."""

    def __init__(self, inst, slabs, n_tiles, stream):
        self.inst, self.slabs, self.n_tiles, self.stream = inst, slabs, n_tiles, stream
        self.next = 0
        self.host = (torch.empty(inst.shape, dtype=inst.dtype, pin_memory=True)
                     if stream is not None else inst)

    def tile_done(self, i: int) -> None:
        if self.stream is None:
            return
        compute = torch.cuda.current_stream(self.inst.device)
        while self.next < len(self.slabs) and self.slabs[self.next][0] <= i:
            _, x0, x1 = self.slabs[self.next]
            self.next += 1
            self.stream.wait_event(compute.record_event())
            with torch.cuda.stream(self.stream):
                self.host[x0:x1].copy_(self.inst[x0:x1], non_blocking=True)
            trace.count("mask_d2h", "overlapped" if i < self.n_tiles - 1 else "tail")

    def result(self) -> torch.Tensor:
        if self.stream is not None:
            with trace.span("seg.mask_d2h"):
                trace.host_sync("mask.d2h_wait", self.inst.device)
                self.stream.record_event().synchronize()
        return self.host


def _host_mask_factory(origins, crop, volume_shape, device):
    """``start(inst) -> _HostMask`` for one pipeline: the slab plan of its
    assign grid made once, and on a card the copy stream."""
    slabs = mask_slabs(origins, crop, volume_shape[0])
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    return lambda inst: _HostMask(inst, slabs, len(origins), stream)


def _dense_assign(vtile, fg, labels, o, volume_shape, vector_scale, n, decay,
                  exit_fraction, exit_cycle, compact_div):
    """Assignment of one tile by the dense walk (every voxel walks), the
    label gathered at the walk's end in the whole volume; ``fg`` (or None,
    no semantic gate) zeroes the background."""
    x, y, z = volume_shape
    emb = vector_to_embedding(
        vector_scale, vtile[None], n=n, decay=decay,
        exit_fraction=exit_fraction, exit_cycle=exit_cycle,
        compact_div=compact_div)[0]
    trace.host_sync("assign.origin_h2d", vtile.device)
    emb = emb + torch.tensor(o, dtype=torch.float32, device=vtile.device)
    idx = torch.round(emb).to(torch.int64)
    tile_inst = labels[idx[..., 0].clamp(0, x - 1), idx[..., 1].clamp(0, y - 1),
                       idx[..., 2].clamp(0, z - 1)]
    return tile_inst if fg is None else torch.where(fg, tile_inst, 0)


def _forward_sweep(model, volume, mean, std, crop, pads, origins, interior,
                   dtype, prob_threshold, sem_thr, dilation_3d, dilation_2d,
                   device):
    """Phase 1 of the whole-volume pipelines: normalise the volume (a numpy
    array or a tensor) to f32, reflect-pad it, run the model over the tile
    grid of :func:`_tile_grid` and store each tile's interior: the gated
    vectors in ``dtype`` and the mask byte (bit 0 the dilated skeleton, bit
    1 the semantic foreground). Returns ``(vectors [X, Y, Z, 3], mask bytes
    [X, Y, Z])``, views of the padded buffers trimmed to the volume."""
    if not torch.is_tensor(volume):
        volume = torch.from_numpy(np.ascontiguousarray(volume))
    vol = normalized_reflect_pad(volume, mean, std, pads, device)
    padded = tuple(vol.shape)
    vec_buf = torch.zeros((*padded, 3), dtype=dtype, device=device)
    skel_buf = torch.zeros(padded, dtype=torch.uint8, device=device)
    for o in origins:
        with trace.span("seg.tile"):
            tile = vol[tuple(slice(oo, oo + c) for oo, c in zip(o, crop))]
            out = model(tile[None, ..., None])[0]
            vec, skel_u8, sem_u8 = tile_masks(out, prob_threshold, sem_thr,
                                              dilation_3d, dilation_2d)
            dst = tuple(slice(oo + s.start, oo + s.stop) for oo, s in zip(o, interior))
            vec_buf[dst] = vec[interior].to(dtype)
            skel_buf[dst] = (skel_u8 | (sem_u8 << 1))[interior]
    del vol
    trim = tuple(slice(p[0], p[0] + d) for p, d in zip(pads, volume.shape))
    return vec_buf[trim], skel_buf[trim]


def make_device_pipeline(
    model,
    volume_shape: Tuple[int, int, int],
    crop: Tuple[int, int, int] = (256, 256, 16),
    overlap: Tuple[int, int, int] = (16, 16, 2),
    vector_scale: Sequence[float] = (60.0, 60.0, 12.0),
    prob_threshold: float = 0.8,
    embed_iterations: int = 10,
    embed_exit_fraction: float | None = None,
    embed_exit_cycle: bool = False,
    embed_compact_div: int | None = None,
    cc_rounds: int = 32,
    cc_propagates_per_round: int = 128,
    cc_jumps_per_round: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
):
    """The single-program whole-volume pipeline (port of
    ``skoots_tpu/infer/device_pipeline.py::make_device_pipeline``): its own
    defaults, one assignment grid equal to the forward's crop, and no
    options beyond these.

    Build ``run(volume, mean, std) -> int32 instance labels [X, Y, Z]`` on
    ``device`` (by default the first CUDA card; asking for CUDA without one
    raises) for one volume shape; ``model`` is the port's
    ``SpatialEmbedding`` on that device. On a card the labels come back in
    pinned host memory, complete (:class:`_HostMask`); elsewhere on
    ``device``. As JAX's:

    1. the crop is clamped to the volume rounded down to a multiple of 4,
       the overlap to a quarter of the crop; the volume is normalised and
       reflect-padded by ``(o, max(o, c - (d + o)))`` an axis; each tile's
       vectors are gated by ``prob > prob_threshold``, its skeleton
       probability gated, dilated in 3D once and in-plane twice and then
       thresholded; the interiors are stored, vectors rounded to ``dtype``;
    2. the whole volume's CC of the dilated skeleton: JAX's
       ``label_components`` with ``cc_rounds`` rounds of
       ``cc_propagates_per_round`` propagate passes and ``cc_jumps_per_round``
       pointer jumps (``SKOOTS_CC_IMPL`` and ``SKOOTS_CC_SCANS`` are not
       read);
    3. the assignment over tiles of the crop on the unpadded volume (no
       overlap; the last origin of an axis is clamped, so tiles overlap and
       later tiles overwrite earlier ones): the dense walk of the stored
       vectors read back as f32, its end clipped to the volume, the label
       there gated by the semantic bit.

    ``run.last_phase_s`` holds the phase split of the last call,
    ``run.last_cc_rounds`` / ``run.last_cc_converged`` the CC's telemetry
    and ``run.tile_plan`` the tiles of phases 1 and 3.
    """
    device = resolve_device(device)
    x, y, z = volume_shape
    crop, pads, _, origins, interior = _tile_grid(volume_shape, crop, overlap)
    # JAX's label_components reads no environment: the schedule as given
    cc = _stepped_labeller((x, y, z), 1, 26, cc_propagates_per_round,
                           cc_jumps_per_round, 0)
    a_origins = crop_origins((x, y, z), crop, (0, 0, 0))
    host_mask = _host_mask_factory(a_origins, crop, volume_shape, device)

    @torch.no_grad()
    @trace.spanned("seg.block", root=True)
    def run(volume, mean, std):
        phase = _phase_clock(run, device)
        with phase("1-forward"):
            vec_full, skel_full = _forward_sweep(
                model, volume, mean, std, crop, pads, origins, interior, dtype,
                prob_threshold, prob_threshold, 1, 2, device)

        with phase("2-cc"):
            labels = cc(skel_full & 1, max_rounds=cc_rounds)
            run.last_cc_rounds = cc.last_rounds
            run.last_cc_converged = cc.last_converged

        with phase("3-assign"):
            inst = torch.zeros((x, y, z), dtype=torch.int32, device=device)
            landing = host_mask(inst)
            for i, o in enumerate(a_origins):
                sl = tuple(slice(oo, oo + c) for oo, c in zip(o, crop))
                inst[sl] = _dense_assign(
                    vec_full[sl].float(), (skel_full[sl] >> 1) > 0, labels, o,
                    (x, y, z), vector_scale, embed_iterations, 1.0,
                    embed_exit_fraction, embed_exit_cycle, embed_compact_div)
                landing.tile_done(i)
            mask = landing.result()
        return mask

    run.last_phase_s = {}
    run.last_cc_rounds = None
    run.last_cc_converged = None
    run.tile_plan = {"forward": len(origins), "assign": len(a_origins)}
    return run


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
    ``SpatialEmbedding`` on that device. On a card the labels come back in
    pinned host memory, complete, each X-slab copied while the assign tiles
    after it run (:class:`_HostMask`); elsewhere on ``device``.

    On a card the allocator's cache is released at the start and after
    phases 1 and 2 (:func:`_release_cache`), as the thrifty pipeline's.
    Knobs are the JAX package's. ``embed_compact_div`` (with the semantic
    gate) selects the fg-compacted assignment; torch's ``nonzero`` needs no
    capacity, so its value only switches the path on. ``cc_impl``
    ``"sparse"`` (or env ``SKOOTS_CC_IMPL=sparse``) labels the mask with
    :func:`label_components_sparse` (capacity ``cc_n_max``, JAX's rule) and
    runs the dense stepped CC only when its ``ok`` is False; ``"auto"``
    and ``"dense"`` run the dense one. ``cc_scans_per_round`` leads each
    dense round with axis sweeps. ``tiles_per_dispatch``
    is accepted for signature parity: eager PyTorch has no compiled
    dispatch to chunk. ``run.last_phase_s`` holds the phase split of the
    last call, ``run.last_cc_impl`` the CC engine that ran (and
    ``run.last_sparse_cc`` the sparse CC's points, edges, rounds and ``ok``
    when it was tried),
    ``run.last_cc_rounds`` / ``run.last_cc_converged`` the CC
    telemetry (for the sparse engine its union-find rounds), ``run.tile_plan``
    the tiles of phase 1 and phase 3.
    """
    device = resolve_device(device)
    x, y, z = volume_shape
    crop, pads, _, origins, interior = _tile_grid(volume_shape, crop, overlap)
    sem_thr = prob_threshold if semantic_threshold is None else semantic_threshold
    stepped_cc = make_label_components_stepped(
        (x, y, z), rounds_per_dispatch=1, propagates_per_round=cc_propagates_per_round,
        jumps_per_round=cc_jumps_per_round, scans_per_round=cc_scans_per_round)
    use_sparse_cc = os.environ.get("SKOOTS_CC_IMPL", cc_impl) == "sparse"
    cc_n_max = max(1 << 14, ((x * y * z) // 32 + 8191) // 8192 * 8192)

    a_crop, a_origins, compact_assign = _assign_plan(
        volume_shape, assign_crop or crop, vector_scale, embed_iterations,
        embed_decay, embed_compact_div and semantic_gate, device)
    host_mask = _host_mask_factory(a_origins, a_crop, volume_shape, device)

    @torch.no_grad()
    @trace.spanned("seg.block", root=True)
    def run(volume, mean, std):
        phase = _phase_clock(run, device)
        with phase("1-forward"):
            _release_cache(device)
            vec_full, skel_full = _forward_sweep(
                model, volume, mean, std, crop, pads, origins, interior, dtype,
                prob_threshold, sem_thr, dilation_3d, dilation_2d, device)
            _release_cache(device)

        with phase("2-cc"):
            sparse_ok = False
            run.last_sparse_cc = None
            if use_sparse_cc:
                labels, sparse_ok = label_components_sparse(skel_full & 1, n_max=cc_n_max)
                run.last_sparse_cc = dict(label_components_sparse.last_stats, ok=sparse_ok)
            if sparse_ok:
                run.last_cc_impl = "sparse"
                run.last_cc_rounds = run.last_sparse_cc["rounds"]
                run.last_cc_converged = True
            else:
                labels = None  # a failed sparse attempt's labels go before the dense CC
                labels = stepped_cc(skel_full & 1, max_rounds=cc_rounds)
                run.last_cc_impl = "dense"
                run.last_cc_rounds = stepped_cc.last_rounds
                run.last_cc_converged = stepped_cc.last_converged
            _release_cache(device)

        with phase("3-assign"):
            inst = torch.zeros((x, y, z), dtype=torch.int32, device=device)
            landing = host_mask(inst)
            for i, o in enumerate(a_origins):
                sl = tuple(slice(oo, oo + c) for oo, c in zip(o, a_crop))
                vtile = vec_full[sl].float()
                fg = (skel_full[sl] >> 1) > 0
                if compact_assign is not None:
                    inst[sl] = compact_assign(vtile, fg, labels, o)
                else:
                    inst[sl] = _dense_assign(
                        vtile, fg if semantic_gate else None, labels, o, (x, y, z),
                        vector_scale, embed_iterations, embed_decay,
                        embed_exit_fraction, embed_exit_cycle, embed_compact_div)
                landing.tile_done(i)
            mask = landing.result()
        return mask

    run.last_phase_s = {}
    run.last_cc_impl = None
    run.last_sparse_cc = None
    run.last_cc_rounds = None
    run.last_cc_converged = None
    run.tile_plan = {"forward": len(origins), "assign": len(a_origins)}
    return run


def segment_volume_chunked(model, volume, mean, std, **kwargs):
    """One call of :func:`make_chunked_pipeline` built for ``volume``'s
    shape (``kwargs`` are its knobs, ``device`` among them): on a card the
    labels in pinned host memory."""
    run = make_chunked_pipeline(model, tuple(volume.shape), **kwargs)
    return run(volume, mean, std)


def _release_cache(device: torch.device) -> None:
    """Hand the caching allocator's unused blocks back to the card, so the
    buffers a phase keeps get segments of their own instead of splitting
    the blocks the previous phase's tiles left, which can strand the free
    memory a later tile needs. The span ``seg.release_cache``."""
    if device.type == "cuda":
        with trace.span("seg.release_cache"):
            trace.count("host_sync", "release_cache.empty_cache")
            torch.cuda.empty_cache()


def make_thrifty_pipeline(
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
    tiles_per_dispatch: int = 16,
    device=None,
):
    """The device-thrifty whole-volume pipeline: about 13 B a voxel at its
    peak instead of :func:`make_chunked_pipeline`'s 24.

    * The volume stays on the device in its native dtype (1 B a voxel for
      uint8 EM data); each tile is normalised as it is cut.
    * No vector buffer: phase 3 runs the forward again on each assign tile,
      without a reflect halo (the walk gathers from the whole label
      volume, so only the vectors of the tile's border voxels change), and
      walks the fresh field at once, rounded to f16 as a stored field is.
    * After CC the labels are compacted to 1..N (``_compact_labels``) and
      held in 16 bits when N < 2^16, and so is the instance mask.
    * On a card the allocator's cache is released at the start and after
      phases 1 and 2 (:func:`_release_cache`).

    Knobs are :func:`make_chunked_pipeline`'s but ``cc_impl``: as the JAX
    package's, the CC is always the dense stepped one, whatever
    ``SKOOTS_CC_IMPL`` says. ``tiles_per_dispatch`` is accepted for
    signature parity, as :func:`make_chunked_pipeline`'s is: eager PyTorch has no
    compiled dispatch to chunk. Returns ``run(volume, mean,
    std) -> instance labels [X, Y, Z]``, already numbered 1..N: uint16 when
    N < 2^16 (:func:`widen_u16` widens it), else int32; on a card in pinned
    host memory, complete, as :func:`make_chunked_pipeline`'s.
    ``run.last_count`` holds N, ``run.last_phase_s`` the phase split,
    ``run.last_cc_rounds`` / ``run.last_cc_converged`` the CC telemetry and
    ``run.tile_plan`` the forward's tiles in phase 1 and phase 3.
    """
    device = resolve_device(device)
    x, y, z = volume_shape
    crop, pads, (px, py, pz), origins, interior = _tile_grid(
        volume_shape, crop, overlap)
    cx, cy, cz = crop
    sem_thr = prob_threshold if semantic_threshold is None else semantic_threshold
    stepped_cc = make_label_components_stepped(
        (x, y, z), rounds_per_dispatch=1, propagates_per_round=cc_propagates_per_round,
        jumps_per_round=cc_jumps_per_round, scans_per_round=cc_scans_per_round)

    a_crop, a_origins, compact_assign = _assign_plan(
        volume_shape, assign_crop or crop, vector_scale, embed_iterations,
        embed_decay, embed_compact_div and semantic_gate, device)
    lo = tuple(p[0] for p in pads)
    host_mask = _host_mask_factory(a_origins, a_crop, volume_shape, device)

    def forward(tile, mean, std):
        return model(((widen_u16(tile).float() - mean) / std)[None, ..., None])[0]

    @torch.no_grad()
    @trace.spanned("seg.block", root=True)
    def run(volume, mean, std):
        phase = _phase_clock(run, device)
        mean, std = float(mean), float(std)
        with phase("1-forward"):
            _release_cache(device)
            if not torch.is_tensor(volume):
                volume = torch.from_numpy(np.ascontiguousarray(volume))
            # native dtype; a uint16 one pads as int16
            vol = trace.to_device(volume, device, "forward.volume_h2d")
            if vol.dtype == torch.uint16:
                vol = reflect_pad(vol.view(torch.int16), pads).view(torch.uint16)
            else:
                vol = reflect_pad(vol, pads)
            skel_buf = torch.zeros((px, py, pz), dtype=torch.uint8, device=device)
            for o in origins:
                with trace.span("seg.tile"):
                    out = forward(vol[o[0]:o[0] + cx, o[1]:o[1] + cy, o[2]:o[2] + cz],
                                  mean, std)
                    _, skel_u8, _ = tile_masks(out, prob_threshold, sem_thr,
                                               dilation_3d, dilation_2d)
                    dst = tuple(slice(oo + s.start, oo + s.stop)
                                for oo, s in zip(o, interior))
                    skel_buf[dst] = skel_u8[interior]
            _release_cache(device)

        with phase("2-cc"):
            skel = skel_buf[tuple(slice(p, p + d) for p, d in zip(lo, (x, y, z)))]
            del skel_buf  # the CC takes a contiguous mask as its fg
            labels = stepped_cc(skel, max_rounds=cc_rounds)
            del skel
            run.last_cc_rounds = stepped_cc.last_rounds
            run.last_cc_converged = stepped_cc.last_converged
            # held in 16 bits when N fits; gathered and written through the
            # int16 view, which every device's kernels take, viewed as uint16
            # on return
            labels, n = _compact_labels(labels, narrow16=True)
            run.last_count = n
            _release_cache(device)

        with phase("3-assign"):
            inst = torch.zeros((x, y, z), dtype=labels.dtype, device=device)
            landing = host_mask(inst)
            for i, o in enumerate(a_origins):
                sl = tuple(slice(oo, oo + c) for oo, c in zip(o, a_crop))
                out = forward(vol[tuple(slice(oo + p, oo + p + c)
                                        for oo, p, c in zip(o, lo, a_crop))],
                              mean, std)
                prob = out[..., 4]
                keep = (prob > prob_threshold).to(out.dtype)[..., None]
                vtile = (out[..., 0:3] * keep).to(torch.float16).float()
                fg = prob > sem_thr
                if compact_assign is not None:
                    inst[sl] = compact_assign(vtile, fg, labels, o)
                else:
                    inst[sl] = _dense_assign(
                        vtile, fg if semantic_gate else None, labels, o, (x, y, z),
                        vector_scale, embed_iterations, embed_decay,
                        embed_exit_fraction, embed_exit_cycle, embed_compact_div)
                landing.tile_done(i)
            mask = landing.result()
        return mask.view(torch.uint16) if mask.dtype == torch.int16 else mask

    run.last_phase_s = {}
    run.last_count = None
    run.last_cc_rounds = None
    run.last_cc_converged = None
    run.tile_plan = {"forward": len(origins), "assign": len(a_origins)}
    return run


def estimated_device_bytes(volume_shape, thrifty: bool = False,
                           itemsize: int = 1, tile_bytes: int = 0) -> int:
    """Peak device memory of :func:`make_chunked_pipeline`: 24 B a voxel
    (phase 1: the native volume briefly, the padded f32 volume 4 built in
    place (:func:`normalized_reflect_pad`), bf16 vectors 6, the mask byte
    1; phase 2: vectors and mask 7, the CC's fg 1 and its bool test 1,
    labels 4 and scratch 4, 17 in all; phase 3: vectors and mask 7, labels
    4, instances 4; the rest covers the allocator's rounding and the
    segments a phase's tiles leave, released at the phase ends). With
    ``thrifty``, :func:`make_thrifty_pipeline`'s: 12 B a voxel and the
    native volume's ``itemsize`` (phase 2: the volume, the mask as the CC's
    fg 1, labels 4, scratch 4 and the fg test 1, with 2 to spare), 13 for
    uint8 EM data. Both add ``tile_bytes``, one forward tile's peak (the
    phase-1 tile; the thrifty assign tile when that is larger), which the
    caller measures."""
    x, y, z = volume_shape
    per_voxel = 12 + int(itemsize) if thrifty else 24
    return int(x) * int(y) * int(z) * per_voxel + int(tile_bytes)
