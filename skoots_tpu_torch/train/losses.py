"""Loss functions (port of ``skoots_tpu/train/losses.py``).

All losses take channels-last ``[B, *spatial, C]`` tensors; ground truth
arrives binarised (the train step passes ``masks > 0``), so each loss is the
binary case, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from skoots_tpu_torch.ops.morphology import binary_erosion


def tversky(alpha: float, beta: float, eps: float = 1e-8) -> Callable:
    """Tversky loss: ``alpha`` weighs false positives, ``beta`` false
    negatives; the mean over batch items of the per-item loss."""

    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        p = pred.float().reshape(pred.shape[0], -1)
        g = gt.float().reshape(gt.shape[0], -1)
        tp = (p * g).sum(1)
        fp = ((p * (1.0 - g)).sum(1) + 1e-10) * alpha
        fn_ = ((1.0 - p) * g).sum(1) * beta
        return (1.0 - (tp + eps) / (tp + fp + fn_ + eps)).mean()

    return fn


def dice(eps: float = 1e-10) -> Callable:
    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        p, g = pred.float(), gt.float()
        intersection = (p * g).sum() + eps
        denominator = (p + g).sum() + eps
        return 1.0 - 2.0 * intersection / denominator

    return fn


def jaccard(eps: float = 1e-10) -> Callable:
    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        p, g = pred.float(), gt.float()
        intersection = (p * g).sum() + eps
        union = (p + g).sum() - intersection + eps
        return 1.0 - intersection / union

    return fn


def _maxpool(x: torch.Tensor, window) -> torch.Tensor:
    """Max over a centred window of the spatial axes of a channels-last
    tensor, padding with -inf (``reduce_window(max)`` with init -inf)."""
    y = x.movedim(-1, 1)
    pad = tuple((w - 1) // 2 for w in window)
    pool = F.max_pool3d if len(window) == 3 else F.max_pool2d
    return pool(y, tuple(window), stride=1, padding=pad).movedim(1, -1)


def soft_erode(img: torch.Tensor) -> torch.Tensor:
    if img.ndim == 4:  # [B, X, Y, C]
        return torch.minimum(-_maxpool(-img, (3, 1)), -_maxpool(-img, (1, 3)))
    p1 = -_maxpool(-img, (3, 1, 1))
    p2 = -_maxpool(-img, (1, 3, 1))
    p3 = -_maxpool(-img, (1, 1, 3))
    return torch.minimum(torch.minimum(p1, p2), p3)


def soft_dilate(img: torch.Tensor) -> torch.Tensor:
    return _maxpool(img, (3, 3) if img.ndim == 4 else (3, 3, 3))


def soft_open(img: torch.Tensor) -> torch.Tensor:
    return soft_dilate(soft_erode(img))


def soft_skeletonize(img: torch.Tensor, iters: int) -> torch.Tensor:
    """Iterative soft thinning."""
    skel = F.relu(img - soft_open(img))
    for _ in range(iters):
        img = soft_erode(img)
        delta = F.relu(img - soft_open(img))
        skel = skel + F.relu(delta - skel * delta)
    return skel


def soft_cldice(iters: int = 3, smooth: float = 1.0) -> Callable:
    """Centerline-Dice loss on the full (binary) channel stack."""

    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        p, g = pred.float(), gt.float()
        sp = soft_skeletonize(p, iters)
        st = soft_skeletonize(g, iters)
        tprec = ((sp * g).sum() + smooth) / (sp.sum() + smooth)
        tsens = ((st * p).sum() + smooth) / (st.sum() + smooth)
        return 1.0 - 2.0 * (tprec * tsens) / (tprec + tsens)

    return fn


def soft_dice_cldice(iters: int = 3, alpha: float = 0.5, smooth: float = 1.0) -> Callable:
    """Blend of dice and clDice."""
    _dice = dice()
    _cl = soft_cldice(iters, smooth)

    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        return (1.0 - alpha) * _dice(pred, gt) + alpha * _cl(pred, gt)

    return fn


def split_loss(n_iter: int = 2, alpha: float = 2.0) -> Callable:
    """Skeleton-breakage penalty: edges of the prediction crossing the
    interior of the ground truth (weighted by a pseudo-distance from its
    erosions) get an exponential penalty."""

    def fn(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        pred, gt = pred.float(), gt.float()
        distance, g = gt, gt
        for _ in range(n_iter):
            g = binary_erosion(g)
            distance = distance + g
        distance = distance / max(n_iter - 1, 1)
        edges = (pred - binary_erosion(pred)) * 2.0
        return torch.pow(edges.clamp_min(0.0), alpha * distance).mean()

    return fn


_VALID_LOSSES = {
    "tversky": tversky,
    "dice": lambda **kw: dice(**{k: v for k, v in kw.items() if k == "eps"}),
    "jaccard": lambda **kw: jaccard(**{k: v for k, v in kw.items() if k == "eps"}),
    "soft_cldice": soft_cldice,
    "soft_dice_cldice": soft_dice_cldice,
}


def cfg_loss(name: str, keywords: list, values: list) -> Callable:
    """Build a loss from the cfg's (name, keywords, values) triple."""
    if name not in _VALID_LOSSES:
        raise RuntimeError(f"unknown loss {name!r}; valid: {list(_VALID_LOSSES)}")
    return _VALID_LOSSES[name](**dict(zip(keywords, values)))
