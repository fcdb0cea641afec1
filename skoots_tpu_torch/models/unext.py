"""UNeXT-3D: ConvNeXt-style 3D UNet backbone in PyTorch, channels-last.

Port of ``skoots_tpu/models/unext.py:64-499`` (``UNeXT3D`` and its
blocks). Every public tensor is ``[B, X, Y, Z, C]`` as in the JAX package.
Parameter names and layouts follow the flax tree (see
``checkpoint.torch_params_from_flax``).

Dtype policy, as the JAX model's: parameters are f32, compute runs in the
model dtype (bf16 for the bench checkpoint), LayerNorm statistics are f32
with eps 1e-6, GELU is the exact-erf form. The depthwise convs, the fused
block tails, the 2x trilinear upsample and the fused final LN + head run in
the hand-written kernels (``kernels/``); the strided Downsample conv and the
skip-fusing 1x1 conv are plain torch, as the JAX package leaves them to
XLA. Those plain ops reproduce flax's rounding points: a convolution or
matmul accumulates in f32 and rounds once to the model dtype, then its bias
add rounds again.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skoots_tpu_torch.kernels.dwconv import dwconv3d
from skoots_tpu_torch.kernels.lnhead import ln_head
from skoots_tpu_torch.kernels.mlp import mlp_block_tail
from skoots_tpu_torch.kernels.upsample import upsample2x

LN_EPS = 1e-6  # flax nn.LayerNorm default


def _rnd(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round to ``dt`` and return as f32 (the value flax computes with)."""
    return t.to(dt).float()


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` / 1x1 ``nn.Conv`` at dtype ``dt``: f32 accumulation
    of dt-rounded operands, rounded to ``dt``, then a ``dt`` bias add."""
    y = _rnd(x.float() @ _rnd(w, dt), dt)
    return (y + _rnd(b, dt)).to(dt)


def flax_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    dt: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dt)`` over the last axis: f32 statistics with
    flax's fast variance ``E[x^2] - E[x]^2``, f32 scale and bias."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale)
    return (y + bias).to(dt)


class LayerNormParams(nn.Module):
    """LayerNorm parameters (flax ``scale``/``bias`` -> ``weight``/``bias``);
    the normalisation itself runs inside the fused kernels or
    :func:`flax_layer_norm`."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))


class Dense(nn.Module):
    """``weight`` ``[din, dout]`` (flax layout), ``bias`` ``[dout]``."""

    def __init__(self, din: int, dout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(din, dout, device=device))
        self.bias = nn.Parameter(torch.zeros(dout, device=device))


class DWConv3D(nn.Module):
    """Depthwise k^3 SAME conv, ``weight`` ``[k, k, k, C]``, on the dwconv
    kernel: f32 accumulation and bias, one rounding to the model dtype."""

    def __init__(self, dim: int, kernel_size: int = 7,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        k = kernel_size
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(k, k, k, dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return dwconv3d(x.to(dt), _rnd(self.weight, dt), _rnd(self.bias, dt))


class StemConv3D(DWConv3D):
    """Dense k^3 conv from ONE input channel: exactly the depthwise conv of
    the input broadcast across C channels (``unext.py:161-167``). The
    dwconv kernel reads the single channel with stride 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 1:
            raise ValueError(f"StemConv3D takes one input channel, got {x.shape[-1]}")
        return super().forward(x)


class ConvNeXtBlock3D(nn.Module):
    """Depthwise k^3 conv, then the fused tail ``shortcut + gamma *
    pw2(GELU(pw1(LN(.))))`` (kernels/mlp.py)."""

    def __init__(self, dim: int, kernel_size: int = 7,
                 layer_scale_init: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.dwconv = DWConv3D(dim, kernel_size, dtype, device)
        self.norm = LayerNormParams(dim, device)
        self.pw1 = Dense(dim, 4 * dim, device)
        self.pw2 = Dense(4 * dim, dim, device)
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init),
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        h = self.dwconv(x)
        return mlp_block_tail(h, x, self.norm.weight, self.norm.bias,
                              self.pw1.weight, self.pw1.bias,
                              self.pw2.weight, self.pw2.bias, self.gamma)


class Downsample(nn.Module):
    """LayerNorm + strided 2^3 conv (resolution /2, channels -> dim), plain
    torch; ``conv.weight`` ``[2, 2, 2, Cin, dim]`` (flax layout)."""

    def __init__(self, din: int, dim: int, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.norm = LayerNormParams(din, device)
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.zeros(2, 2, 2, din, dim, device=device))
        self.conv.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        h = flax_layer_norm(x, self.norm.weight, self.norm.bias, dt)
        w = _rnd(self.conv.weight, dt).permute(4, 3, 0, 1, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv3d(h.float().permute(0, 4, 1, 2, 3), w, stride=2)
        y = _rnd(y.permute(0, 2, 3, 4, 1), dt)
        return (y + _rnd(self.conv.bias, dt)).to(dt)


class ConcatConv3D(nn.Module):
    """Skip fusion: concat the decoder stream with the encoder skip, then a
    1^3 conv (flax Dense ``fuse``) to ``dim``."""

    def __init__(self, din: int, dim: int, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.fuse = Dense(din, dim, device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x, skip.to(x.dtype)], dim=-1)
        return dense(y, self.fuse.weight, self.fuse.bias, self.compute_dtype)


class UNeXT3D(nn.Module):
    """stem -> k encoder stages -> bottleneck -> k decoder stages -> fused
    LN + 1x1 head. Submodule names are the flax ones (``enc0_block1``,
    ``down0``, ``concat1``, ``final_norm``, ...)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 dims: Sequence[int] = (32, 64, 128, 64, 32),
                 depths: Sequence[int] = (2, 2, 2, 2, 2), kernel_size: int = 7,
                 layer_scale_init_value: float = 1.0, activation: str = "gelu",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if len(dims) % 2 != 1 or len(depths) != len(dims):
            raise ValueError(f"dims {dims} / depths {depths}: need odd, equal lengths")
        if in_channels != 1 or activation != "gelu" or layer_scale_init_value <= 0:
            raise NotImplementedError(
                "the port runs UNeXT3D with one input channel, exact GELU and "
                "layer scale > 0; other variants are queued in ROADMAP.md")
        self.compute_dtype = dtype
        self.dims, self.depths = list(dims), list(depths)
        kd = len(dims) // 2
        self.k_down = kd

        def stage(name, dim, depth):
            for i in range(depth):
                self.add_module(f"{name}_block{i}", ConvNeXtBlock3D(
                    dim, kernel_size, layer_scale_init_value, dtype, device))

        self.stem = StemConv3D(dims[0], kernel_size, dtype, device)
        for s in range(kd):
            stage(f"enc{s}", dims[s], depths[s])
            self.add_module(f"down{s}", Downsample(dims[s], dims[s + 1], dtype, device))
        stage("bottleneck", dims[kd], depths[kd])
        for s in range(kd):
            d = kd + 1 + s
            self.add_module(f"concat{s}", ConcatConv3D(
                dims[d - 1] + dims[kd - 1 - s], dims[d], dtype, device))
            stage(f"dec{s}", dims[d], depths[d])
        self.final_norm = LayerNormParams(dims[-1], device)
        self.head_conv = Dense(dims[-1], out_channels, device)

    def _stage(self, x, name, depth):
        for i in range(depth):
            x = getattr(self, f"{name}_block{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kd = self.k_down
        x = self.stem(x.to(self.compute_dtype))
        skips = []
        for s in range(kd):
            x = self._stage(x, f"enc{s}", self.depths[s])
            skips.append(x)
            x = getattr(self, f"down{s}")(x)
        x = self._stage(x, "bottleneck", self.depths[kd])
        for s in range(kd):
            x = upsample2x(x)
            x = getattr(self, f"concat{s}")(x, skips[kd - 1 - s])
            x = self._stage(x, f"dec{s}", self.depths[kd + 1 + s])
        return ln_head(x, self.final_norm.weight, self.final_norm.bias,
                       self.head_conv.weight, self.head_conv.bias)
