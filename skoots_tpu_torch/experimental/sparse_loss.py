"""Sparse (weakly supervised) losses (port of
``skoots_tpu/experimental/sparse_loss.py``): supervision is skeleton
points and certain-background labels, no instance masks.

Channels-last, as the port's dense losses. JAX's ``vmap`` over the batch
is a loop over its samples: each bakes its merged skeleton points against
an all-ones mask through the bake kernel (``kernels/bake.py``; on a CUDA
tensor the hand-written kernel), one launch a sample.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from skoots_tpu_torch.ops.embed2prob import baked_embed_to_prob
from skoots_tpu_torch.ops.skeleton import PackedSkeletons, bake_skeleton

_NEIGHBOR_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]


def vector_direction_penalty(vectors: torch.Tensor) -> torch.Tensor:
    """Direction smoothness: per voxel, the mean over its nonzero 3^3
    neighbours of ``1 - cos^2`` between its vector and theirs.
    ``vectors`` ``[B, X, Y, Z, 3]``; returns ``[B, X, Y, Z]``. A neighbour
    beyond the volume is zero, so it never counts."""
    v = vectors.float()
    c_mag = torch.sqrt(torch.sum(v * v, -1) + 1e-8)
    padded = F.pad(v, (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    count = torch.zeros_like(acc)
    for off in _NEIGHBOR_OFFSETS:
        nb = padded
        for ax, d in enumerate(off):  # the neighbour at -d: nb[i] = v[i - d]
            nb = nb.narrow(1 + ax, 1 - d, v.shape[1 + ax])
        nb2 = torch.sum(nb * nb, -1)
        n_mag = torch.sqrt(nb2 + 1e-8)
        dot = torch.sum(nb * v, -1)
        cos2 = (dot / (n_mag * c_mag + 1e-8)) ** 2
        valid = nb2 > 1e-8
        acc = acc + torch.where(valid, 1.000001 - cos2, 0.0)
        count = count + valid.float()
    return acc / count.clamp_min(1.0)


def closest_skeleton(points: torch.Tensor, valid: torch.Tensor, shape: Tuple[int, int, int],
                     anisotropy: Tuple[float, float, float]):
    """Bake ALL skeleton points as one merged instance against an all-ones
    mask: (baked ``[X, Y, Z, 3]``, smoothed as training does, and dist
    ``[X, Y, Z]``). With no valid point: baked 1000 and dist 100."""
    ones = torch.ones(shape, dtype=torch.int32, device=points.device)
    packed = PackedSkeletons(points.float(), valid.to(torch.int32))
    baked, dist = bake_skeleton(ones, packed, anisotropy, average=True, return_distance=True)
    any_valid = valid.any()
    return (torch.where(any_valid, baked, 1000.0), torch.where(any_valid, dist, 100.0))


def _masked_mse(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(value * value * mask) / mask.sum().clamp_min(1.0)


def sparse_background_loss(embed_prob: torch.Tensor, background: torch.Tensor,
                           multiplier: float) -> torch.Tensor:
    """Mean square of the embedding probability on certain-background
    voxels, times ``multiplier``."""
    return _masked_mse(embed_prob, (background > 0.5).float()) * multiplier


def sparse_embed_loss(embed_prob: torch.Tensor, skeleton_distance: torch.Tensor,
                      background: torch.Tensor, distance_thr: float) -> torch.Tensor:
    """Mean square of ``1 - embed_prob`` within ``distance_thr`` of a
    skeleton, certain background excluded; with no such voxel, that of the
    single closest voxel (the first at the least distance)."""
    mask = ((skeleton_distance < distance_thr) & (background <= 0.5)).float()
    count = mask.sum()
    main = torch.sum((1.0 - embed_prob) ** 2 * mask) / count.clamp_min(1.0)
    idx = torch.argmin(skeleton_distance.reshape(-1))
    fallback = (1.0 - embed_prob.reshape(-1)[idx]) ** 2
    return torch.where(count > 0, main, fallback)


def embed_distance(embed: torch.Tensor, baked: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between embedding and baked skeleton,
    ``[X, Y, Z, 3]`` -> ``[X, Y, Z]``."""
    d = embed.float() - baked.float()
    return torch.sqrt(torch.sum(d * d, -1))


def sparse_loss(
    embed: torch.Tensor,
    vectors: torch.Tensor,
    points: torch.Tensor,
    valid: torch.Tensor,
    background: torch.Tensor,
    semantic: torch.Tensor,
    sigma,
    anisotropy: Tuple[float, float, float],
    distance_thr: float,
    bg_multiplier: float,
):
    """``(background_loss, embed_loss, embed_prob)``. ``embed`` and
    ``vectors`` (already times the vector scale) ``[B, X, Y, Z, 3]``,
    ``points`` ``[B, P, 3]``, ``valid`` ``[B, P]`` bool, ``background`` and
    ``semantic`` (the model's output) ``[B, X, Y, Z, 1]``; ``sigma`` the
    Gaussian's per-axis bandwidth. The semantic head is supervised by the
    embedding probability thresholded at 0.2 (a Dice loss)."""
    shape = tuple(embed.shape[1:4])
    penalty = vector_direction_penalty(vectors).mean(dim=(1, 2, 3))
    embed_losses, probs = [], []
    for i in range(embed.shape[0]):
        baked, dist = closest_skeleton(points[i], valid[i], shape, anisotropy)
        prob = baked_embed_to_prob(embed[i][None], baked[None], sigma)[0, ..., 0]
        bg = background[i, ..., 0]
        a = sparse_background_loss(prob, bg, bg_multiplier)
        b = sparse_embed_loss(prob, embed_distance(embed[i], baked), bg, distance_thr)
        e = sparse_embed_loss(prob, dist, bg, distance_thr)
        embed_losses.append(a + b + e + penalty[i])
        probs.append(prob)
    probs = torch.stack(probs)
    pred_bin = (probs[..., None] > 0.2).float()
    sem = semantic.float()
    inter = torch.sum(pred_bin * sem) + 1e-8
    denom = torch.sum(pred_bin + sem) + 1e-8
    return 1.0 - 2.0 * inter / denom, torch.stack(embed_losses).mean() / 2.0, probs
