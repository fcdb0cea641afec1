"""Spatial embedding -> Gaussian probability against a baked skeleton.

Port of ``skoots_tpu/ops/embed2prob.py``: per voxel, channels-last,

    phi(E, S) = exp( sum_k (E_k - S_k)^2 / (-2 sigma_k^2) )
"""

from __future__ import annotations

import torch

from skoots_tpu_torch.utils import trace


def baked_embed_to_prob(
    embedding: torch.Tensor,
    baked_skeletons: torch.Tensor,
    sigma,
    eps: float = 1e-16,
) -> torch.Tensor:
    """``embedding`` and ``baked_skeletons`` ``[B, *spatial, D]``; ``sigma``
    per-axis bandwidth ``(D,)``. Returns ``[B, *spatial, 1]`` f32
    probabilities in (0, 1]."""
    trace.host_sync("embed_prob.sigma_h2d", embedding.device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=embedding.device) + eps
    denom = sigma * sigma * -2.0
    diff = embedding.float() - baked_skeletons.float()
    return torch.exp(torch.sum(diff * diff / denom, dim=-1, keepdim=True))
