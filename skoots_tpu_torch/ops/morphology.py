"""Binary dilation as windowed maxima on channels-last tensors.

Port of ``skoots_tpu/ops/morphology.py:33-40``: the JAX ops are
``reduce_window(max)`` with init 0 and zero padding, so every output is
``max(0, window max over the zero-padded input)``; the same here. Input
``[B, X, Y, Z, C]`` (any rank >= 4, window on the three axes before the
channel axis).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def binary_dilation(image: torch.Tensor, window=(3, 3, 3)) -> torch.Tensor:
    """3D dilation (26-neighbourhood max for the default 3^3 window)."""
    lead = image.shape[:-4]
    x = image.reshape(-1, *image.shape[-4:]).movedim(-1, 1)  # [N, C, X, Y, Z]
    dt = x.dtype
    xf = x if dt.is_floating_point else x.float()
    pad = []
    for w in reversed(window):
        pad += [(w - 1) // 2, (w - 1) // 2]
    y = F.max_pool3d(F.pad(xf, pad, value=0.0), tuple(window), stride=1)
    y = y.clamp_min(0).to(dt)
    return y.movedim(1, -1).reshape(*lead, *y.shape[2:], y.shape[1])


def binary_dilation_2d(image: torch.Tensor) -> torch.Tensor:
    """Per-slice in-plane dilation: 3 x 3 over X, Y (window 3 x 3 x 1)."""
    return binary_dilation(image, window=(3, 3, 1))
