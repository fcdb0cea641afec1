"""TensorBoard image panels (port of ``skoots_tpu/train/viz.py``).

Renders a mid-depth slice grid per epoch: image / mask / overlay / optical-
flow rendering of the vector field / embedding probability / predicted +
GT skeleton maps, stacked vertically in that order. The flow is an HSV
wheel (hue = direction, saturation = magnitude) in numpy; the HSV -> RGB
conversion is :func:`hsv_to_rgb`, numpy's own copy of
``matplotlib.colors.hsv_to_rgb`` (no matplotlib needed).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``[..., 3]`` HSV in [0, 1] -> RGB in [0, 1], by the six hue sectors
    of ``matplotlib.colors.hsv_to_rgb`` (h = 1 falls in sector 0)."""
    hsv = np.asarray(hsv)
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32), copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = i % 6
    r = np.choose(sector, [v, q, p, p, t, v])
    g = np.choose(sector, [t, v, v, q, p, p])
    b = np.choose(sector, [p, p, t, v, v, q])
    grey = s == 0
    rgb = np.stack([np.where(grey, v, r), np.where(grey, v, g), np.where(grey, v, b)], -1)
    return rgb.astype(hsv.dtype, copy=False)


def flow_to_image(flow_xy: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 color wheel."""
    fx, fy = flow_xy[..., 0], flow_xy[..., 1]
    mag = np.sqrt(fx * fx + fy * fy)
    ang = (np.arctan2(fy, fx) + np.pi) / (2 * np.pi)  # 0..1
    mmax = mag.max() if mag.max() > 0 else 1.0
    hsv = np.stack([ang, np.clip(mag / mmax, 0, 1), np.ones_like(ang)], -1)
    return (hsv_to_rgb(hsv) * 255).astype(np.uint8)


def mask_overlay(mask: np.ndarray, prob: np.ndarray) -> np.ndarray:
    """[H, W] binary mask + [H, W] probability -> [H, W, 3] overlay."""
    base = np.stack([prob, prob, prob], -1)
    base[..., 0] = np.where(mask > 0.5, 0.7 * mask + 0.3 * prob, base[..., 0])
    return np.clip(base, 0, 1)


def _norm(x: np.ndarray) -> np.ndarray:
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def write_progress(
    writer,
    tag: str,
    epoch: int,
    images: np.ndarray,  # [B, X, Y, Z, 1]
    masks: np.ndarray,  # [B, X, Y, Z, 1]
    vector: np.ndarray,  # [B, X, Y, Z, 3]
    embed_prob: np.ndarray,  # [B, X, Y, Z, 1]
    predicted_skeleton: Optional[np.ndarray] = None,
    gt_skeleton: Optional[np.ndarray] = None,
    z: Optional[int] = None,
) -> np.ndarray:
    """Stack the panels of sample 0 at slice ``z`` (default the middle)
    vertically, log them as one HWC uint8 image and return the f32 grid."""
    z = z if z is not None else images.shape[3] // 2
    img = _norm(np.asarray(images[0, :, :, z, 0], np.float32))
    panels = [np.stack([img] * 3, -1)]
    m = np.asarray(masks[0, :, :, z, 0] > 0.5, np.float32)
    panels.append(np.stack([m] * 3, -1))
    p = _norm(np.asarray(embed_prob[0, :, :, z, 0], np.float32))
    panels.append(mask_overlay(m, p))
    panels.append(flow_to_image(np.asarray(vector[0, :, :, z, 0:2], np.float32)) / 255.0)
    panels.append(np.stack([p] * 3, -1))
    if predicted_skeleton is not None:
        s = _norm(np.asarray(predicted_skeleton[0, :, :, z, 0], np.float32))
        panels.append(np.stack([s] * 3, -1))
    if gt_skeleton is not None:
        s = np.asarray(gt_skeleton[0, :, :, z, 0] > 0.5, np.float32)
        panels.append(np.stack([s] * 3, -1))

    grid = np.concatenate(panels, axis=0)  # stack vertically
    if writer is not None:
        writer.add_image(tag, (grid * 255).astype(np.uint8), epoch, dataformats="HWC")
    return grid
