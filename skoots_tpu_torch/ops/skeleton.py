"""Skeleton ops: packing, baking, averaging, painting and embedding lookup.

Port of ``skoots_tpu/ops/skeleton.py``. All skeleton points of all
instances are packed into one ``[P, 3]`` tensor with per-point instance ids
(0 = padding). :func:`bake_skeleton` finds, per voxel, the nearest point of
the voxel's own instance with the bake kernel (``kernels/bake.py``) -- on a
CUDA tensor always the hand-written kernel, on a CPU tensor its plain
version.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel


class PackedSkeletons(NamedTuple):
    """``points`` ``[P, 3]`` f32 skeleton vertices (padded); ``ids`` ``[P]``
    int32 instance id per point, 0 marks padding."""

    points: torch.Tensor
    ids: torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_skeletons(skeletons: Dict[int, np.ndarray], device=None) -> PackedSkeletons:
    """Pack a ``{id: [M, 3]}`` skeleton dict into flat arrays, padded to the
    next multiple of 128 points (at least 128)."""
    pts, ids = [], []
    for k, v in skeletons.items():
        if int(k) == -1:
            continue
        v = np.asarray(v, dtype=np.float32).reshape(-1, 3)
        pts.append(v)
        ids.append(np.full((v.shape[0],), int(k), dtype=np.int32))
    points = np.concatenate(pts, 0) if pts else np.zeros((0, 3), np.float32)
    pids = np.concatenate(ids, 0) if ids else np.zeros((0,), np.int32)
    p = points.shape[0]
    target = max(_round_up(p, 128), 128)
    points = np.pad(points, ((0, target - p), (0, 0)))
    pids = np.pad(pids, (0, target - p))
    return PackedSkeletons(torch.from_numpy(points).to(device),
                           torch.from_numpy(pids).to(device))


def bake_skeleton(
    masks: torch.Tensor,
    skeletons: PackedSkeletons,
    anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    average: bool = True,
    return_distance: bool = False,
):
    """Per-voxel closest skeleton vertex of the voxel's own instance.

    ``masks`` ``[X, Y, Z]`` integer instance ids (0 = background);
    ``anisotropy`` weights the squared per-axis distances. ``average``
    smooths the baked field with :func:`average_baked_skeletons`, as
    training uses it. Returns baked ``[X, Y, Z, 3]`` f32 (0 at background),
    and with ``return_distance`` also the ``[X, Y, Z]`` distances the
    kernel found (of the unsmoothed points)."""
    baked, dist = bake_skeleton_kernel(masks, skeletons.points, skeletons.ids, anisotropy)
    if average:
        baked = average_baked_skeletons(baked[None])[0]
    return (baked, dist) if return_distance else baked


def _window_sum(t: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-padded k^3 window sum over the spatial axes of ``[B, X, Y, Z,
    C]``, one axis at a time."""
    h = k // 2
    for ax in (1, 2, 3):
        n = t.shape[ax]
        pad = [0, 0] * (t.ndim - ax - 1) + [h, h]
        tp = torch.nn.functional.pad(t, pad)
        s = tp.narrow(ax, 0, n)
        for d in range(1, k):
            s = s + tp.narrow(ax, d, n)
        t = s
    return t


def average_baked_skeletons(baked: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Mean over the k^3 neighbourhood counting only nonzero entries: the
    window sum divided by the count of strictly positive entries (at least
    1), as ``skoots_tpu``'s two reduce_windows. ``baked`` ``[B, X, Y, Z, 3]``."""
    total = _window_sum(baked.float(), kernel_size)
    count = _window_sum((baked > 0).float(), kernel_size)
    return total / count.clamp_min(1.0)


def _disk_offsets(radius: int, flank_radius: int) -> np.ndarray:
    """Stamp offsets: a disk of ``radius`` in the centre z-plane flanked by
    disks of ``flank_radius`` at z = +/-1, centred (numpy, copied)."""

    def disk(r: int) -> np.ndarray:
        g = np.arange(-r, r + 1)
        xx, yy = np.meshgrid(g, g, indexing="ij")
        return (xx * xx + yy * yy) <= r * r

    center = disk(radius)
    flank = np.pad(disk(flank_radius), radius - flank_radius)
    total = np.stack((flank, center, flank), axis=-1)
    offs = np.argwhere(total).astype(np.int32)
    offs[:, 2] -= 1
    offs[:, 0] -= radius
    offs[:, 1] -= radius
    return offs


def skeleton_to_mask(
    skeletons: PackedSkeletons,
    shape: Tuple[int, int, int],
    radius: int = 7,
    flank_radius: int = 3,
) -> torch.Tensor:
    """Paint the disk + flank stamp at every (rounded half to even) skeleton
    vertex. Returns ``[X, Y, Z]`` f32. As the JAX package's scatter
    (``.at[].set(mode="drop")``, which normalises negative indices first):
    a stamp voxel at ``-size <= i < 0`` wraps to ``i + size``, one further
    out or at ``i >= size`` is dropped."""
    dev = skeletons.points.device
    offs = torch.from_numpy(_disk_offsets(radius, flank_radius)).to(dev)
    pts = torch.round(skeletons.points).to(torch.int64)
    coords = (pts[:, None, :] + offs[None, :, :].to(torch.int64)).reshape(-1, 3)
    valid = (skeletons.ids != 0)[:, None].expand(-1, offs.shape[0]).reshape(-1)
    lim = torch.tensor(shape, dtype=torch.int64, device=dev)
    coords = torch.where(coords < 0, coords + lim, coords)
    valid = valid & ((coords >= 0) & (coords < lim)).all(-1)
    coords = coords[valid]
    mask = torch.zeros(shape, dtype=torch.float32, device=dev)
    mask[coords[:, 0], coords[:, 1], coords[:, 2]] = 1.0
    return mask


def index_skeleton_by_embed(skeleton: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Instance id per voxel: the labelled-skeleton voxel its embedding
    lands on (rounded half to even, clipped). ``skeleton`` ``[Xs, Ys, Zs]``,
    ``embed`` ``[B, X, Y, Z, 3]``; returns ``[B, X, Y, Z]`` int32."""
    sx, sy, sz = skeleton.shape
    idx = torch.round(embed).to(torch.int64)
    ix = idx[..., 0].clamp(0, sx - 1)
    iy = idx[..., 1].clamp(0, sy - 1)
    iz = idx[..., 2].clamp(0, sz - 1)
    return skeleton.to(torch.int32)[ix, iy, iz]
