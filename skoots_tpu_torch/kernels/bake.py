"""Skeleton bake: per voxel, the nearest skeleton point of its own instance.

Replaces ``skoots_tpu/kernels/bake.py::_bake_call`` (the Pallas running
arg-min over blocks of points). The Hopper kernel is ``csrc/bake.cu``: one
thread per voxel, as the original SKOOTS's GPU kernel, with the points
staged in shared memory block by block (see the source header).

On the TPU, ``ops/skeleton.py::bake_skeleton`` takes this kernel only at
P >= 8192 points and an MXU matmul (``|c|^2 + |s|^2 - 2 c.s``) below; the
card has no MXU, so the port bakes a CUDA tensor with the kernel always.
Both versions here follow the Pallas kernel's direct-difference formula,
``d2 = dx*dx*wx + dy*dy*wy + dz*dz*wz`` with every product and sum rounded
on its own, and keep the FIRST minimal point, so they agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from skoots_tpu_torch.kernels import _build
from skoots_tpu_torch.ops.vec2embed import coordinate_mesh

BIG = 3.4e38  # the Pallas kernel's "no point yet" distance


def bake_skeleton_ref(
    masks: torch.Tensor,
    points: torch.Tensor,
    ids: torch.Tensor,
    anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``masks`` int ``[X, Y, Z]``, ``points`` f32
    ``[P, 3]``, ``ids`` int ``[P]`` (0 = padding). Returns baked f32
    ``[X, Y, Z, 3]`` and dist f32 ``[X, Y, Z]``; voxels without an
    own-instance point get 0 for both. ``[chunk, P]`` distance tiles;
    ``torch.argmin`` returns the first minimum."""
    shape = tuple(masks.shape)
    dev = masks.device
    coords = coordinate_mesh(shape, device=dev).reshape(-1, 3)
    mflat = masks.reshape(-1).to(torch.int32)
    pts = points.float()
    pid = ids.to(torch.int32)
    w = [float(a) for a in anisotropy]
    baked = torch.zeros((coords.shape[0], 3), dtype=torch.float32, device=dev)
    dist = torch.zeros(coords.shape[0], dtype=torch.float32, device=dev)
    if pts.shape[0] == 0:
        return baked.reshape(*shape, 3), dist.reshape(shape)
    for s in range(0, coords.shape[0], chunk):
        c = coords[s:s + chunk]
        m = mflat[s:s + chunk]
        dx = c[:, 0:1] - pts[None, :, 0]
        dy = c[:, 1:2] - pts[None, :, 1]
        dz = c[:, 2:3] - pts[None, :, 2]
        d2 = dx * dx * w[0] + dy * dy * w[1] + dz * dz * w[2]
        valid = (pid[None, :] == m[:, None]) & (pid[None, :] != 0)
        d2 = torch.where(valid, d2, torch.full_like(d2, BIG))
        best = torch.argmin(d2, dim=1)
        mind2 = torch.gather(d2, 1, best[:, None])[:, 0]
        found = mind2 < BIG
        baked[s:s + chunk] = torch.where(found[:, None], pts[best], 0.0)
        dist[s:s + chunk] = torch.where(found, torch.sqrt(mind2.clamp_min(0.0)), 0.0)
    return baked.reshape(*shape, 3), dist.reshape(shape)


@_build.on_device
def bake_skeleton_kernel(
    masks: torch.Tensor,
    points: torch.Tensor,
    pids: torch.Tensor,
    anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bake: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (raises on what the kernel does not take)."""
    if masks.device.type == "cpu":
        return bake_skeleton_ref(masks, points, pids, anisotropy)
    _build.require_cuda(masks, "bake_skeleton")
    if masks.ndim != 3 or points.ndim != 2 or points.shape[-1] != 3:
        raise ValueError(f"bake_skeleton: masks {tuple(masks.shape)}, "
                         f"points {tuple(points.shape)}")
    p = points.shape[0]
    _build.check_operands("bake_skeleton", masks.device, pids=(pids, (p,)),
                          points=(points, (p, 3)))
    xs, ys, zs = masks.shape
    m = masks.to(torch.int32).contiguous()
    pts = points.float().contiguous()
    pid = pids.to(torch.int32).contiguous()
    baked = torch.empty((xs, ys, zs, 3), dtype=torch.float32, device=masks.device)
    dist = torch.empty((xs, ys, zs), dtype=torch.float32, device=masks.device)
    wx, wy, wz = (float(a) for a in anisotropy)
    code = _build.library().skoots_bake(
        m.data_ptr(), pts.data_ptr(), pid.data_ptr(), p, xs, ys, zs, wx, wy,
        wz, baked.data_ptr(), dist.data_ptr(), _build.stream_ptr(masks))
    _build.check(code, "bake_skeleton")
    bake_skeleton_kernel.launches += 1
    return baked, dist


bake_skeleton_kernel.launches = 0
