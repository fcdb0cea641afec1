"""Morphology on channels-last tensors (port of ``skoots_tpu/ops/morphology.py``).

Input ``[B, X, Y, Z, C]`` (any rank >= 4, window on the three axes before
the channel axis), as in the JAX package:

* :func:`binary_dilation` / :func:`binary_dilation_2d`: JAX's
  ``reduce_window(max)`` has init 0 and zero padding, so every output is
  ``max(0, window max over the zero-padded input)``; the same here;
* :func:`binary_erosion`: window minimum over the zero-padded input, so the
  edges erode (the reference's conv with zero padding, then min);
* :func:`mean_filter`: window sum in f32 over the zero-padded input, over
  the window's size;
* :func:`median_filter`: median of the shifted copies, which WRAP around the
  borders (JAX's ``jnp.roll``, not zero padding); integer input gives f32,
  as ``jnp.median`` does;
* :func:`gauss_filter`: separable Gaussian, f32 1D taps normalised to sum 1,
  zero padding, each axis summed tap by tap in order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_AXES = (-4, -3, -2)  # X, Y, Z of a channels-last tensor


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


def _zero_pad(x: torch.Tensor, window) -> torch.Tensor:
    """Zero-pad the X, Y, Z axes by ``(w - 1) // 2`` on each side."""
    pad = [0, 0]  # the channel axis
    for w in reversed(window):
        pad += [(w - 1) // 2, (w - 1) // 2]
    return F.pad(x, pad, value=0)


def _windowed(x: torch.Tensor, window, op) -> torch.Tensor:
    """``op``-reduce each axis's window in turn over the zero-padded ``x``
    (separable: min and sum are reduced axis by axis)."""
    x = _zero_pad(x, window)
    for ax, w in zip(_AXES, window):
        n = x.shape[ax] - (w - 1)
        acc = x.narrow(ax, 0, n)
        for i in range(1, w):
            acc = op(acc, x.narrow(ax, i, n))
        x = acc
    return x


def binary_erosion(image: torch.Tensor, window=(3, 3, 3)) -> torch.Tensor:
    """3D erosion: the window minimum over the zero-padded input, so the
    volume's edges erode. Exact for every dtype."""
    if image.dtype == torch.bool:
        return _windowed(image.to(torch.uint8), window, torch.minimum).bool()
    return _windowed(image, window, torch.minimum)


def mean_filter(image: torch.Tensor, window=(3, 3, 3)) -> torch.Tensor:
    """Window mean in f32, the zero-padded borders included."""
    total = _windowed(image.float(), window, torch.add)
    return total / float(math.prod(window))


def median_filter(image: torch.Tensor, window=(3, 3, 3)) -> torch.Tensor:
    """Median of the window's shifted copies, which wrap around at the
    borders (as JAX's ``jnp.roll``). Small windows only."""
    wx, wy, wz = window
    shifts = [torch.roll(image, (dx, dy, dz), dims=_AXES)
              for dx in range(-(wx // 2), wx // 2 + 1)
              for dy in range(-(wy // 2), wy // 2 + 1)
              for dz in range(-(wz // 2), wz // 2 + 1)]
    stack = torch.stack(shifts, 0)
    if not stack.dtype.is_floating_point:
        stack = stack.float()
    # an odd count of copies: the middle value, as jnp.median's
    return stack.median(dim=0).values


def gauss_filter(image: torch.Tensor, kernel, sigma) -> torch.Tensor:
    """Separable 3D Gaussian blur in f32: per axis with ``k > 1``, taps
    ``exp(-x^2 / 2 sigma^2)`` at ``linspace(-(k-1)/2, (k-1)/2, k)``
    normalised to sum 1, over the zero-padded axis."""
    out = image.float()
    for ax, k, s in zip(_AXES, kernel, sigma):
        if k <= 1:
            continue
        half = (k - 1) * 0.5
        x = torch.linspace(-half, half, k, dtype=torch.float32, device=out.device)
        k1d = torch.exp(-0.5 * (x / s) ** 2)
        k1d = k1d / k1d.sum()
        window = [1, 1, 1]
        window[ax + 4] = k
        padded = _zero_pad(out, window)
        n = out.shape[ax]
        acc = torch.zeros_like(out)
        for i in range(k):
            acc = acc + padded.narrow(ax, i, n) * k1d[i]
        out = acc
    return out
