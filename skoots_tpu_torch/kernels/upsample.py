"""2x trilinear upsample of ``[B, X, Y, Z, C]`` (the decoder's
UpSampleLayer3D): half-pixel centres, edge clamp, an f32 cascade over x, y
and z, one rounding to the input dtype.

Replaces ``skoots_tpu/kernels/upsample.py::_upsample2x_call`` (the Pallas
kernel behind ``upsample2x_trilinear``). The Hopper kernel is
``csrc/upsample.cu``: one thread per input element writes its 2x2x2 outputs
from the 3x3x3 neighbourhood, with the plain version's roundings, so the
two agree bit for bit (see the source header).

:func:`upsample2x` is a ``torch.autograd.Function`` on both devices. The op
is linear, so its backward keeps only the dtype and is the transpose of the
plain cascade (:func:`upsample2x_transpose`, plain torch), as JAX's ``_bwd``
is the XLA transpose; the JAX package has no backward kernel here.
"""

from __future__ import annotations

import torch

from skoots_tpu_torch.kernels import _build


def _upsample2x_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Half of a separable 2x trilinear upsample along one axis (half-pixel
    centres, edge clamp): out[2i] = 0.75 x[i] + 0.25 x[i-1], out[2i+1] =
    0.75 x[i] + 0.25 x[i+1], clamped at the ends."""
    n = x.shape[axis]
    lo = torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], axis)
    even = 0.75 * x + 0.25 * lo
    odd = 0.75 * x + 0.25 * hi
    shape = list(x.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], axis + 1).reshape(shape)


def _upsample2x_axis_transpose(g: torch.Tensor, axis: int) -> torch.Tensor:
    """Transpose of :func:`_upsample2x_axis`: x[i] receives 0.75 of both its
    outputs, and 0.25 of out[2i+2] and out[2i-1], which read it as their
    neighbour (at the clamped ends, x[0] also of out[0] and x[n-1] of
    out[2n-1])."""
    n = g.shape[axis] // 2
    pairs = g.unflatten(axis, (n, 2))
    ge, go = pairs.select(axis + 1, 0), pairs.select(axis + 1, 1)
    zero = torch.zeros_like(ge.narrow(axis, 0, 1))
    lo = torch.cat([ge.narrow(axis, 1, n - 1), zero], axis)
    lo.narrow(axis, 0, 1).add_(ge.narrow(axis, 0, 1))
    hi = torch.cat([zero, go.narrow(axis, 0, n - 1)], axis)
    hi.narrow(axis, n - 1, 1).add_(go.narrow(axis, n - 1, 1))
    return 0.75 * (ge + go) + 0.25 * (lo + hi)


def upsample2x_transpose(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The vjp of :func:`upsample2x_ref` for a cotangent ``g`` of the output
    shape: the f32 transpose of the cascade (z, then y, then x), rounded to
    the input's ``dtype``."""
    d = g.float()
    for ax in (3, 2, 1):
        d = _upsample2x_axis_transpose(d, ax)
    return d.to(dtype)


def upsample2x_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 cascade over the three spatial axes of
    ``[B, X, Y, Z, C]``, one rounding to x's dtype (as ``_xla_upsample``)."""
    y = x.float()
    for ax in (1, 2, 3):
        y = _upsample2x_axis(y, ax)
    return y.to(x.dtype)


def _upsample2x_fwd(x: torch.Tensor) -> torch.Tensor:
    """One launch (or the plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return upsample2x_ref(x)
    _build.require_cuda(x, "upsample2x")
    if x.ndim != 5 or x.dtype not in _build.DTYPE_CODES or x.numel() == 0:
        raise ValueError(f"upsample2x: unsupported x {tuple(x.shape)} {x.dtype}")
    b, xs, ys, zs, c = x.shape
    x = x.contiguous()
    out = torch.empty((b, 2 * xs, 2 * ys, 2 * zs, c), dtype=x.dtype, device=x.device)
    code = _build.library().skoots_upsample2x(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), b, xs, ys, zs,
        c, _build.stream_ptr(x))
    _build.check(code, "upsample2x")
    upsample2x.launches += 1
    return out


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return _upsample2x_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_transpose(g, ctx.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x trilinear upsample: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (raises on what the kernel
    does not take: a non-5-D tensor, a dtype other than f32/bf16)."""
    return _Upsample2x.apply(x)


upsample2x.launches = 0
