"""The per-slice 2D mode for heavily anisotropic stacks.

Port of ``skoots_tpu/infer/perslice.py``: every z-slice is segmented on its
own in 2D (8-connected components of the skeleton, the 2D embedding walk,
the label gather, the semantic gate), then the slices' instances are
stitched across z on the host where they overlap at the same (x, y).

On the device the slices run together. The CC puts a group of g slices on
the even planes of one ``[2g - 1, X, Y]`` volume with an empty plane
between neighbours, so the 26-connected stepped CC (the propagate kernel
on a card) links nothing across slices and labels every slice of the group
in the same launches; a plane's offset is subtracted afterwards. A group
holds up to ``SLICE_GROUP_VOXELS`` spaced voxels (512 slices of 512^2), so
large stacks stay within int32 addresses. JAX's vmapped fixpoint loop
freezes the slices that have converged and runs the rest up to
``max_rounds``; a fixpoint stays a fixpoint, so running every slice of a
group until the group's fixpoint or the cap gives its labels exactly. The
walk treats z as the batch axis.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from skoots_tpu_torch.ops.flood_fill import (
    _stepped_labeller,
    _UnionFind,
    drop_small_instances,
    remap_labels,
    renumber,
)
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.utils import trace
from skoots_tpu_torch.utils.device import resolve_device

# spaced voxels of one group's stepped CC: its int32 voxel addresses stay
# below 2^31, and its two int32 volumes (labels and scratch) at 2 GiB
SLICE_GROUP_VOXELS = 1 << 28


def perslice_label_components(skel_zxy: torch.Tensor,
                              max_rounds: int = 64) -> torch.Tensor:
    """8-connected components of each slice of ``skel_zxy`` ``[Z, X, Y]``,
    the slices in groups of up to ``SLICE_GROUP_VOXELS`` spaced voxels,
    one stepped CC a group (one propagation pass and two pointer jumps a
    round, as ``label_components``' defaults; ``SKOOTS_CC_SCANS`` is not
    read, as there). Returns int32 ``[Z, X, Y]`` labels in each slice's own
    convention: ``x * Y + y + 1`` of its component's maximum voxel, 0 off
    the skeleton. ``perslice_label_components.last_rounds`` holds the rounds
    run over all groups (one propagate launch each on a card)."""
    z, x, y = skel_zxy.shape
    out = torch.zeros((z, x, y), dtype=torch.int32, device=skel_zxy.device)
    group = max(1, (SLICE_GROUP_VOXELS // max(1, x * y) + 1) // 2)
    rounds = 0
    for s in range(0, z, group):
        g = min(group, z - s)
        spaced = torch.zeros((2 * g - 1, x, y), dtype=torch.uint8, device=skel_zxy.device)
        spaced[0::2] = skel_zxy[s:s + g] > 0
        label = _stepped_labeller(spaced.shape, rounds_per_dispatch=1, connectivity=26,
                                  propagates_per_round=1, jumps_per_round=2,
                                  scans_per_round=0)
        lab = label(spaced, max_rounds=max_rounds)[0::2]
        rounds += label.last_rounds
        offset = torch.arange(0, 2 * g, 2, dtype=torch.int32,
                              device=lab.device).view(g, 1, 1) * (x * y)
        out[s:s + g] = torch.where(lab > 0, lab - offset, 0)
        del spaced, lab
    perslice_label_components.last_rounds = rounds
    return out


perslice_label_components.last_rounds = None


def _perslice_assign(vec_zxy2: torch.Tensor, skel_zxy: torch.Tensor,
                     sem_zxy: torch.Tensor, scale_xy, n_iter: int) -> torch.Tensor:
    """Per-slice 2D CC, 2D embedding walk and gather, batched over z
    (``perslice.py:34``). Returns int32 ``[Z, X, Y]`` slice-local labels,
    0 outside the semantic mask."""
    z, x, y = skel_zxy.shape
    labels2d = perslice_label_components(skel_zxy)
    emb = vector_to_embedding(scale_xy, vec_zxy2.float(), n=n_iter)
    idx = torch.round(emb).to(torch.int64)
    ix = idx[..., 0].clamp(0, x - 1)
    iy = idx[..., 1].clamp(0, y - 1)
    inst = torch.gather(labels2d.reshape(z, -1), 1,
                        (ix * y + iy).reshape(z, -1)).view(z, x, y)
    return torch.where(sem_zxy > 0, inst, 0)


def perslice_segment(
    vectors: np.ndarray,
    skeleton: np.ndarray,
    semantic: np.ndarray,
    vector_scale: Sequence[float] = (60.0, 60.0, 12.0),
    embed_iterations: int = 10,
    min_instance_size: int = -1,
    device=None,
) -> np.ndarray:
    """Segment an anisotropic stack slice by slice, then stitch across z.

    ``vectors`` ``[X, Y, Z, 3]`` (only the x and y channels are used),
    ``skeleton`` and ``semantic`` ``[X, Y, Z]`` masks (any nonzero is
    foreground; memmaps are read once). The slices run on ``device`` (by
    default the first CUDA card; asking for CUDA without one raises).
    Slice-local labels are made
    unique with a span of ``X * Y + 1`` per slice, instances of consecutive
    slices that share an (x, y) position are merged by a host union-find,
    then the speck filter (``min_instance_size``: -1 auto, 0 off) and a
    renumber to 1..N. Returns ``[X, Y, Z]`` int32.
    ``perslice_segment.last_phase_s`` holds the seconds of the last call's
    ``assign`` (the slices' CC, walk and gather, with the transfers) and
    ``stitch`` (the union-find, speck filter and renumber on the host), the
    spans ``perslice.assign`` and ``perslice.stitch``."""
    device = resolve_device(device)
    phase = trace.PhaseClock(perslice_segment, "perslice")
    with phase("assign"):
        x, y, z = skeleton.shape
        vec2 = np.ascontiguousarray(np.moveaxis(np.asarray(vectors)[..., :2], 2, 0))
        skel_z = np.ascontiguousarray(np.moveaxis(np.asarray(skeleton) > 0, 2, 0))
        sem_z = np.ascontiguousarray(np.moveaxis(np.asarray(semantic) > 0, 2, 0))
        with torch.no_grad():
            inst = _perslice_assign(
                torch.from_numpy(vec2).to(device), torch.from_numpy(skel_z).to(device),
                torch.from_numpy(sem_z).to(device), tuple(vector_scale[:2]),
                embed_iterations)
            inst_z = inst.cpu().numpy().astype(np.int64)
        del inst

    with phase("stitch"):
        # globally unique ids: slice-local labels are raveled 2D indices + 1
        span = x * y + 1
        inst_z += (np.arange(z, dtype=np.int64) * span)[:, None, None] * (inst_z > 0)

        # stitch: same-position overlap between consecutive slices
        uf = _UnionFind()
        for k in range(z - 1):
            a, b = inst_z[k], inst_z[k + 1]
            m = (a > 0) & (b > 0)
            if m.any():
                for pa, pb in np.unique(np.stack([a[m], b[m]], axis=1), axis=0):
                    uf.union(int(pa), int(pb))
        if uf.parent:
            keys = np.fromiter(uf.parent.keys(), dtype=np.int64)
            roots = np.array([uf.find(int(k)) for k in keys], dtype=np.int64)
            changed = keys != roots
            if changed.any():
                inst_z = remap_labels(inst_z, keys[changed], roots[changed])

        out = np.moveaxis(inst_z, 0, 2)  # [X, Y, Z]
        out, _ = drop_small_instances(out, min_instance_size)
        out, _ = renumber(out)
    return out.astype(np.int32)


perslice_segment.last_phase_s = {}


def run_perslice_inference(
    image_path: str,
    checkpoint_path: str,
    vector_scale: Sequence[float] | None = None,
    embed_iterations: int = 10,
    prob_threshold: float = 0.8,
    crop_size: Tuple[int, int, int] = (300, 300, 20),
    overlap: Tuple[int, int, int] = (50, 50, 5),
    output_path: str | None = None,
    min_instance_size: int = -1,
    device=None,
) -> np.ndarray:
    """The per-slice mode on an image file: phase 1 (the forward sweep) of
    ``infer.engine.run_inference`` runs once when any of its three cached
    buffers (``<stem>_skoots_vectors.npy``, ``_skeleton.npy``,
    ``_semantic.npy``) is missing -- the whole 3D run, with one walk step,
    as the JAX package does -- then :func:`perslice_segment` on the
    buffers, memory-mapped, with the checkpoint's vector scale unless
    ``vector_scale`` is given. Writes ``<stem>_instance_mask_2d.tif`` (or
    ``output_path``) and returns the mask. ``device`` as
    :func:`perslice_segment`'s."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer.engine import run_inference
    from skoots_tpu_torch.utils.io import imsave

    device = resolve_device(device)
    stem = os.path.splitext(image_path)[0]
    vec_path = stem + "_skoots_vectors.npy"
    skel_path = stem + "_skoots_skeleton.npy"
    sem_path = stem + "_skoots_semantic.npy"
    if not all(os.path.exists(p) for p in (vec_path, skel_path, sem_path)):
        run_inference(image_path, checkpoint_path, crop_size=crop_size,
                      overlap=overlap, prob_threshold=prob_threshold,
                      embed_iterations=1, device=device)
    if not os.path.exists(vec_path):
        raise FileNotFoundError(
            f"{vec_path}: the phase-1 run stored no vector field (volumes over "
            "256^3 voxels run out of core or on the whole-volume device engine, "
            "which recompute the vectors instead of storing them); the per-slice "
            "mode needs the stored field")
    vectors = np.load(vec_path, mmap_mode="r")
    skeleton = np.load(skel_path, mmap_mode="r")
    semantic = np.load(sem_path, mmap_mode="r")
    ckpt = load_checkpoint(checkpoint_path)
    scale = tuple(vector_scale or ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"])
    mask = perslice_segment(vectors, skeleton, semantic, scale, embed_iterations,
                            min_instance_size=min_instance_size, device=device)
    imsave(output_path or (stem + "_instance_mask_2d.tif"), mask)
    return mask
