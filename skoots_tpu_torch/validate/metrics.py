"""Instance-level evaluation metrics on a torch device (port of
``skoots_tpu/validate/metrics.py:18-159``).

The NxM instance tables come from ONE contingency pass: every (gt id,
pred id) voxel pair is coded as one int64, ``gt * (max(pred) + 1) +
pred``, and ``torch.unique`` counts the codes on the device, so the
counts, and the IoU and Dice built from them, equal the JAX package's
exactly. clDice is evaluated per touching pair on the pair's joint
bounding box, padded to power-of-two buckets, with the port's
``train/losses.py::soft_cldice``; the loop over pairs runs on the host.

Every function takes numpy arrays or tensors and a ``device`` (default the
first CUDA card; asking for CUDA without one raises), and returns tensors
on that device (tables), or Python numbers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from skoots_tpu_torch.utils.device import resolve_device


def as_tensor(a, device: torch.device, dtype=torch.int64) -> torch.Tensor:
    """An array or tensor as a ``dtype`` tensor on ``device`` (no copy when
    it is one already)."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def contingency(gt, pred, device=None):
    """Sparse intersection table between two label volumes of one shape.

    Returns (gt_ids [N], pred_ids [M], inter [N, M], gt_areas [N],
    pred_areas [M]), int64 tensors on ``device``; ids ascending, background
    (0) excluded."""
    dev = resolve_device(device)
    gt, pred = as_tensor(gt, dev), as_tensor(pred, dev)
    if gt.shape != pred.shape:
        raise ValueError(f"input volumes differ in shape: {tuple(gt.shape)} "
                         f"vs {tuple(pred.shape)}")
    gt, pred = gt.reshape(-1), pred.reshape(-1)
    gt_ids, gt_areas = torch.unique(gt[gt > 0], return_counts=True)
    pred_ids, pred_areas = torch.unique(pred[pred > 0], return_counts=True)
    inter = torch.zeros((len(gt_ids), len(pred_ids)), dtype=torch.int64,
                        device=dev)
    both = (gt > 0) & (pred > 0)
    if bool(both.any()):
        k = pred.max() + 1
        codes, counts = torch.unique(gt[both] * k + pred[both],
                                     return_counts=True)
        gi = torch.searchsorted(gt_ids, torch.div(codes, k, rounding_mode="floor"))
        pj = torch.searchsorted(pred_ids, codes % k)
        inter[gi, pj] = counts
    return gt_ids, pred_ids, inter, gt_areas, pred_areas


def iou_table(inter, gt_areas, pred_areas) -> torch.Tensor:
    """NxM f64 IoU table from :func:`contingency`'s counts."""
    union = gt_areas[:, None] + pred_areas[None, :] - inter
    return torch.where(union > 0, inter.double() / union.clamp(min=1), 0.0)


def dice_table(inter, gt_areas, pred_areas) -> torch.Tensor:
    """NxM f64 Dice table from :func:`contingency`'s counts."""
    denom = gt_areas[:, None] + pred_areas[None, :]
    return torch.where(denom > 0, 2.0 * inter.double() / denom.clamp(min=1), 0.0)


def mask_iou(gt, pred, device=None) -> torch.Tensor:
    """NxM f64 table of per-instance IoU."""
    return iou_table(*contingency(gt, pred, device)[2:])


def mask_dice(gt, pred, device=None) -> torch.Tensor:
    """NxM f64 table of per-instance Dice."""
    return dice_table(*contingency(gt, pred, device)[2:])


def _bboxes(vol: torch.Tensor, ids: torch.Tensor):
    """Per-id bounding boxes of ``vol`` ``[X, Y, Z]``: (lo [N, 3], hi [N, 3]
    exclusive) int64 for the ascending ``ids``, in one pass over the
    foreground."""
    pts = torch.nonzero(vol > 0)
    slot = torch.searchsorted(ids, vol[pts[:, 0], pts[:, 1], pts[:, 2]])
    slot = slot[:, None].expand(-1, 3)
    n = (len(ids), 3)
    lo = torch.full(n, np.iinfo(np.int64).max, dtype=torch.int64, device=vol.device)
    hi = torch.full(n, -1, dtype=torch.int64, device=vol.device)
    lo = lo.scatter_reduce(0, slot, pts, "amin")
    hi = hi.scatter_reduce(0, slot, pts, "amax") + 1
    return lo, hi


def _bucket(n: int) -> int:
    """The power-of-two crop bucket (at least 8) that holds ``n``."""
    b = 8
    while b < n:
        b *= 2
    return b


def mask_soft_cldice(gt, pred, iters: int = 3, device=None,
                     table=None) -> torch.Tensor:
    """NxM f32 table of per-instance soft-clDice on touching pairs only,
    each evaluated on the pair's joint bounding box. ``table``: the two
    volumes' :func:`contingency`, when the caller has it already."""
    from skoots_tpu_torch.train.losses import soft_cldice

    dev = resolve_device(device)
    gt, pred = as_tensor(gt, dev), as_tensor(pred, dev)
    gt_ids, pred_ids, inter, _, _ = table or contingency(gt, pred, dev)
    out = np.zeros(tuple(inter.shape), np.float32)
    crit = soft_cldice(iters=iters)
    glo, ghi = (t.cpu().numpy() for t in _bboxes(gt, gt_ids))
    plo, phi = (t.cpu().numpy() for t in _bboxes(pred, pred_ids))
    g_ids, p_ids = gt_ids.cpu().numpy(), pred_ids.cpu().numpy()
    for i, j in torch.nonzero(inter > 0).cpu().numpy():
        lo = np.minimum(glo[i], plo[j])
        hi = np.maximum(ghi[i], phi[j])
        sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        a = (gt[sl] == int(g_ids[i])).float()
        b = (pred[sl] == int(p_ids[j])).float()
        # zero padding is clDice-neutral (the soft skeleton of background
        # is 0); F.pad takes the last axis first
        pads = [p for n in reversed(a.shape) for p in (0, _bucket(n) - n)]
        a = F.pad(a, pads)[None, ..., None]
        b = F.pad(b, pads)[None, ..., None]
        # soft_cldice is a LOSS (1 - clDice); the table holds the score
        out[i, j] = 1.0 - float(crit(b, a))
    return torch.from_numpy(out).to(dev)


def accuracies_from_iou(iou, thr: float = 0.1) -> Tuple[int, int, int]:
    """(TP, FP, FN) at an IoU threshold: a GT instance is matched if its
    best IoU exceeds ``thr``; an unmatched prediction is a FP."""
    iou = torch.as_tensor(iou)
    if iou.numel() == 0:
        return 0, int(iou.shape[1]), int(iou.shape[0])
    gt_matched = iou.max(dim=1).values > thr
    pred_matched = iou.max(dim=0).values > thr
    tp = int(gt_matched.sum())
    fn = int((~gt_matched).sum())
    fp = int((~pred_matched).sum())
    return tp, fp, fn


def f1_score(tp: int, fp: int, fn: int) -> float:
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def get_segmentation_errors(gt, pred, device=None) -> Tuple[float, float]:
    """(over_seg_rate, under_seg_rate): the fraction of GT instances that
    match more than one prediction at IoU > 0.2, and vice versa."""
    return segmentation_errors(mask_iou(gt, pred, device))


def segmentation_errors(iou: torch.Tensor) -> Tuple[float, float]:
    """:func:`get_segmentation_errors` from the IoU table."""
    if iou.shape[0] == 0 or iou.shape[1] == 0:
        return 0.0, 0.0
    hit = iou > 0.2
    over = float((hit.sum(dim=1) > 1).double().mean())
    under = float((hit.sum(dim=0) > 1).double().mean())
    return over, under


def mask_to_bbox(mask, device=None) -> Dict[int, torch.Tensor]:
    """Per-instance 3D bounding boxes ``[x0, y0, z0, x1, y1, z1]`` (int64,
    exclusive upper corner)."""
    dev = resolve_device(device)
    mask = as_tensor(mask, dev)
    ids = torch.unique(mask[mask > 0])
    lo, hi = _bboxes(mask, ids)
    boxes = torch.cat([lo, hi], dim=1)
    return {int(u): boxes[i] for i, u in enumerate(ids.tolist())}


def box_iou(a, b, device=None) -> torch.Tensor:
    """f64 IoU table of 3D boxes, ``[N, 6]`` against ``[M, 6]``."""
    dev = resolve_device(device)
    a = as_tensor(a, dev, torch.float64).reshape(-1, 6)
    b = as_tensor(b, dev, torch.float64).reshape(-1, 6)
    lo = torch.maximum(a[:, None, :3], b[None, :, :3])
    hi = torch.minimum(a[:, None, 3:], b[None, :, 3:])
    d = (hi - lo).clamp(min=0)
    inter = d[..., 0] * d[..., 1] * d[..., 2]
    ea, eb = a[:, 3:] - a[:, :3], b[:, 3:] - b[:, :3]
    va = ea[:, 0] * ea[:, 1] * ea[:, 2]
    vb = eb[:, 0] * eb[:, 1] * eb[:, 2]
    union = va[:, None] + vb[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
