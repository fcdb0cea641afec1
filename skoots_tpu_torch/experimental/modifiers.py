"""Ablations of the certain-background supervision (port of
``skoots_tpu/experimental/modifiers.py``): how much background sparse
training needs."""

from __future__ import annotations

import logging

import numpy as np
from scipy import ndimage

log = logging.getLogger(__name__)


def erode_bg_masks(background: np.ndarray, n_erode: float) -> np.ndarray:
    """Erode a binary background volume ``[X, Y, Z]`` ``n_erode`` times
    with a 3^3 structuring element."""
    if n_erode == 0:
        return background
    log.info("eroding background masks n_erode=%s", n_erode)
    out = background > 0
    for _ in range(int(n_erode)):
        out = ndimage.binary_erosion(out, structure=np.ones((3, 3, 3)))
    return out.astype(background.dtype)


def ablate_bg_masks(background: np.ndarray, alpha: float) -> np.ndarray:
    """Zero the background slices from ``int(Z * alpha)`` on."""
    if not 0 < alpha <= 1:
        raise ValueError(f"alpha must be in (0, 1], not {alpha}")
    out = background.copy()
    out[..., int(background.shape[-1] * alpha):] = 0
    return out
