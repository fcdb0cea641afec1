"""The 3D UNet backbones in PyTorch, channels-last: UNeXT-3D (ConvNeXt
blocks) and the classic conv-norm-act UNet3D.

Port of ``skoots_tpu/models/unext.py`` (``UNeXT3D``, ``UNet3D`` and their
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

As in JAX (``unext.py:243-252``), a ConvNeXt block runs the fused tail
kernel only for GELU with a layer scale, no active DropPath and a width the
kernel takes (``mlp_tail_eligible``: C % 8 == 0, C <= 256); otherwise
(relu / silu / selu, ``LAYER_SCALE_INIT_VALUE`` 0, DropPath in training,
another width) it runs flax's plain composition in torch. Likewise the
final head (``unext.py:469-498``) runs the fused LN-head kernel where
``ln_head_eligible`` holds and flax's LayerNorm and 1x1 conv elsewhere. DropPath drops a block's
residual branch per sample (``where(keep, x / keep_prob, 0)``) in training
only, with a mask drawn from the ``torch.Generator`` the caller passes to
``forward`` (the training step seeds it from ``TRAIN.SEED`` and the step;
JAX's PRNG bits cannot be matched). UNet3D's k^3 convs (k =
min(KERNEL_SIZE, 3)), its GroupNorms and 2^3 max pools are plain torch,
its 2x upsample the kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skoots_tpu_torch.kernels.dwconv import dwconv3d
from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_eligible
from skoots_tpu_torch.kernels.mlp import mlp_block_tail, mlp_tail_eligible
from skoots_tpu_torch.kernels.upsample import upsample2x
from skoots_tpu_torch.utils import trace

LN_EPS = 1e-6  # flax nn.LayerNorm default


# flax's activations (jax.nn) at a model dtype, each jnp operation rounded
# to it as the flax model computes them op by op (identities at f32): f32
# arithmetic on dt-rounded values; the caller rounds the result
_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772848170429916717, 1.0507009873554804934193349852946


def _const(v: float, r) -> torch.Tensor:
    return r(torch.tensor(v, dtype=torch.float32))


_ACTIVATIONS = {
    "gelu": lambda x, r: r(0.5 * x) * r(torch.special.erfc(r(-x * _const(math.sqrt(0.5), r)))),
    "relu": lambda x, r: F.relu(x),
    "silu": lambda x, r: x * r(1.0 / r(1.0 + r(torch.exp(-x)))),
    "selu": lambda x, r: _const(_SELU_SCALE, r) * torch.where(
        x > 0, x, r(_const(_SELU_ALPHA, r) * r(torch.expm1(torch.where(x > 0, 0.0, x))))),
}


def _rnd(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round to ``dt`` and return as f32 (the value flax computes with)."""
    return t.to(dt).float()


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` / 1x1 ``nn.Conv`` at dtype ``dt``: f32 accumulation
    of dt-rounded operands, rounded to ``dt``, then a ``dt`` bias add."""
    y = _rnd(x.float() @ _rnd(w, dt), dt)
    return (y + _rnd(b, dt)).to(dt)


def activation(name: str, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``jax.nn``'s activation ``name`` on a ``dt`` tensor, rounded where the
    flax model's operations round (:data:`_ACTIVATIONS`), returned in ``dt``."""
    return _ACTIVATIONS[name](x.float(), lambda t: _rnd(t, dt)).to(dt)


def flax_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, dt: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """flax ``nn.GroupNorm(num_groups=groups, dtype=dt)`` on ``[B, ..., C]``:
    f32 statistics over the spatial axes and each group's channels with
    flax's fast variance (clipped at 0), f32 scale and bias, eps 1e-6."""
    c = x.shape[-1]
    g = x.float().reshape(x.shape[0], -1, groups, c // groups)
    mean = g.mean((1, 3), keepdim=True)
    var = (g.square().mean((1, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    return group_norm_apply(x, mean, var, scale, bias, groups, dt, eps)


def group_norm_apply(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, groups: int,
                     dt: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """:func:`flax_group_norm` given its f32 statistics ``mean`` and ``var``
    (``[B, 1, groups, 1]``), which a sharded forward reduces over every
    slab before it normalises any."""
    c = x.shape[-1]
    g = x.float().reshape(x.shape[0], -1, groups, c // groups)
    y = (g - mean) * (torch.rsqrt(var + eps) * scale.view(groups, c // groups))
    y = y + bias.view(groups, c // groups)
    return y.reshape(x.shape).to(dt)


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


class GroupNorm(LayerNormParams):
    """flax ``nn.GroupNorm`` with ``groups`` groups (:func:`flax_group_norm`)."""

    def __init__(self, dim: int, groups: int, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__(dim, device)
        self.groups = groups
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_group_norm(x, self.weight, self.bias, self.groups, self.compute_dtype)


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


class Conv3D(nn.Module):
    """flax ``nn.Conv(features, (k, k, k), padding="SAME", dtype=dt)`` as
    plain ``F.conv3d``: ``weight`` ``[k, k, k, Cin, Cout]`` (flax layout),
    f32 sums of dt-rounded operands (TF32 off), rounded to dt, then the dt
    bias add. The UNet3D convs and the dense stem of a multi-channel
    UNeXT3D; JAX leaves both to XLA."""

    def __init__(self, din: int, dim: int, kernel_size: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        k = kernel_size
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(k, k, k, din, dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        k = self.weight.shape[0]
        w = _rnd(self.weight, dt).permute(4, 3, 0, 1, 2)
        h = x.to(dt).float().permute(0, 4, 1, 2, 3)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv3d(h, w, padding=k // 2)  # SAME for the odd k cfgs allow
        y = _rnd(y.permute(0, 2, 3, 4, 1), dt)
        return (y + _rnd(self.bias, dt)).to(dt)


class StemConv3D(DWConv3D):
    """Dense k^3 conv from ONE input channel: exactly the depthwise conv of
    the input broadcast across C channels (``unext.py:161-167``). The
    dwconv kernel reads the single channel with stride 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 1:
            raise ValueError(f"StemConv3D takes one input channel, got {x.shape[-1]}")
        return super().forward(x)


class ConvNeXtBlock3D(nn.Module):
    """Depthwise k^3 conv, then ``shortcut + drop(gamma * pw2(act(pw1(LN(.)))))``:
    the fused tail kernel (kernels/mlp.py) for GELU with gamma, no DropPath
    mask and a width it takes, else flax's plain composition
    (:meth:`plain_tail`)."""

    def __init__(self, dim: int, kernel_size: int = 7,
                 layer_scale_init: float = 1.0, drop_path: float = 0.0,
                 activation: str = "gelu", dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: {list(_ACTIVATIONS)}")
        self.compute_dtype = dtype
        self.activation = activation
        self.keep_prob = 1.0 - float(drop_path)
        self.dwconv = DWConv3D(dim, kernel_size, dtype, device)
        self.norm = LayerNormParams(dim, device)
        self.pw1 = Dense(dim, 4 * dim, device)
        self.pw2 = Dense(4 * dim, dim, device)
        # flax declares gamma only for a positive layer scale
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init), device=device)) \
            if layer_scale_init > 0 else None

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: DropPath's per-sample keep mask (bool ``[B]``), or None
        (no DropPath: eval, or a rate of 0)."""
        x = x.to(self.compute_dtype)
        h = self.dwconv(x)
        if keep is None and self.activation == "gelu" and self.gamma is not None \
                and mlp_tail_eligible(h.shape[-1]):
            return mlp_block_tail(h, x, self.norm.weight, self.norm.bias,
                                  self.pw1.weight, self.pw1.bias,
                                  self.pw2.weight, self.pw2.bias, self.gamma)
        return self.plain_tail(h, x, keep)

    def plain_tail(self, h: torch.Tensor, shortcut: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """flax's composition (``unext.py:270-283``) at the model dtype:
        fast-variance LN, dense, activation, dense, layer scale, DropPath
        (``where(keep, y / keep_prob, 0)``, keep_prob in dt as JAX's weak
        scalar), residual add."""
        dt = self.compute_dtype
        y = flax_layer_norm(h, self.norm.weight, self.norm.bias, dt)
        y = dense(y, self.pw1.weight, self.pw1.bias, dt)
        y = activation(self.activation, y, dt)
        y = dense(y, self.pw2.weight, self.pw2.bias, dt)
        if self.gamma is not None:
            y = (y.float() * _rnd(self.gamma, dt)).to(dt)
        if keep is not None:
            scale = torch.tensor(self.keep_prob, dtype=dt).float()
            y = torch.where(keep.view(-1, *([1] * (y.dim() - 1))),
                            (y.float() / scale).to(dt), torch.zeros((), dtype=dt,
                                                                    device=y.device))
        return (shortcut.float() + y.float()).to(dt)


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


def upsample_trilinear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Trilinear upsample of a channels-last ``[B, X, Y, Z, C]`` tensor by
    ``factor`` (JAX's ``models/unext.py::upsample_trilinear``): the 2x
    kernel (:func:`upsample2x`) at factor 2, else the half-pixel trilinear
    resize ``jax.image.resize`` computes (``F.interpolate``,
    ``align_corners=False``), in f32 and cast back to ``x``'s dtype."""
    if factor == 2:
        return upsample2x(x)
    y = F.interpolate(x.movedim(-1, 1).float(), scale_factor=factor, mode="trilinear",
                      align_corners=False)
    return y.movedim(1, -1).to(x.dtype)


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


class DropPathMasks:
    """DropPath keep masks drawn ahead for a whole batch, handed out in
    block order: ``draw(gen, blocks, batch, rate)`` takes from ``gen`` what
    a forward of ``batch`` samples would (one ``[batch]`` draw a block, in
    forward order), and ``shard(start, size)`` gives the masks of the
    samples ``start:start + size``. Passed to ``forward`` in place of the
    generator, each block takes the next mask, so a batch split over
    several forwards (data-parallel training) drops what the whole batch
    would."""

    def __init__(self, masks, start: int = 0, size: Optional[int] = None):
        self.masks = masks
        self.start = start
        self.size = size
        self.used = 0

    @classmethod
    def draw(cls, gen: torch.Generator, blocks: int, batch: int,
             rate: float) -> "DropPathMasks":
        return cls([torch.rand(batch, generator=gen) < 1.0 - rate for _ in range(blocks)])

    def shard(self, start: int, size: int) -> "DropPathMasks":
        return DropPathMasks(self.masks, start, size)

    def next(self, batch: int, device) -> torch.Tensor:
        m = self.masks[self.used]
        self.used += 1
        size = len(m) if self.size is None else self.size
        if size != batch:
            raise ValueError(f"DropPath masks for {size} samples, the block has {batch}")
        return trace.to_device(m[self.start:self.start + size], device, "drop_path.mask_h2d")


def _drop_keep(gen, module: nn.Module, rate: float,
               batch: int, device) -> Optional[torch.Tensor]:
    """One DropPath keep mask (bool ``[batch]``, ``P(keep) = 1 - rate``)
    drawn on the host from ``gen`` (a ``torch.Generator``, or the next of a
    :class:`DropPathMasks`), or None outside training, without a generator
    or at rate 0."""
    if gen is None or not module.training or rate <= 0:
        return None
    if isinstance(gen, DropPathMasks):
        return gen.next(batch, device)
    return trace.to_device(torch.rand(batch, generator=gen) < 1.0 - rate, device,
                           "drop_path.mask_h2d")


class UNeXT3D(nn.Module):
    """stem -> k encoder stages -> bottleneck -> k decoder stages -> fused
    LN + 1x1 head. Submodule names are the flax ones (``enc0_block1``,
    ``down0``, ``concat1``, ``final_norm``, ...). One input channel takes
    the depthwise-kernel stem, several a dense k^3 conv (:class:`Conv3D`)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 dims: Sequence[int] = (32, 64, 128, 64, 32),
                 depths: Sequence[int] = (2, 2, 2, 2, 2), kernel_size: int = 7,
                 drop_path_rate: float = 0.0, layer_scale_init_value: float = 1.0,
                 activation: str = "gelu", dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        if len(dims) % 2 != 1 or len(depths) != len(dims):
            raise ValueError(f"dims {dims} / depths {depths}: need odd, equal lengths")
        self.compute_dtype = dtype
        self.drop_path_rate = float(drop_path_rate)
        self.dims, self.depths = list(dims), list(depths)
        kd = len(dims) // 2
        self.k_down = kd

        def stage(name, dim, depth):
            for i in range(depth):
                self.add_module(f"{name}_block{i}", ConvNeXtBlock3D(
                    dim, kernel_size, layer_scale_init_value, drop_path_rate, activation,
                    dtype, device))

        if in_channels == 1:
            self.stem = StemConv3D(dims[0], kernel_size, dtype, device)
        else:
            self.stem = Conv3D(in_channels, dims[0], kernel_size, dtype, device)
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

    def _stage(self, x, name, depth, gen):
        for i in range(depth):
            keep = _drop_keep(gen, self, self.drop_path_rate, x.shape[0], x.device)
            x = getattr(self, f"{name}_block{i}")(x, keep)
        return x

    def forward(self, x: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``drop_gen``: the generator of the DropPath masks (training
        only; None runs every block without DropPath, as JAX's
        ``deterministic=True``)."""
        kd = self.k_down
        x = self.stem(x.to(self.compute_dtype))
        skips = []
        for s in range(kd):
            x = self._stage(x, f"enc{s}", self.depths[s], drop_gen)
            skips.append(x)
            x = getattr(self, f"down{s}")(x)
        x = self._stage(x, "bottleneck", self.depths[kd], drop_gen)
        for s in range(kd):
            x = upsample2x(x)
            x = getattr(self, f"concat{s}")(x, skips[kd - 1 - s])
            x = self._stage(x, f"dec{s}", self.depths[kd + 1 + s], drop_gen)
        return self.head(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm and 1x1 conv (pointwise)."""
        if ln_head_eligible(x.shape[-1]):
            return ln_head(x, self.final_norm.weight, self.final_norm.bias,
                           self.head_conv.weight, self.head_conv.bias)
        dt = self.compute_dtype
        h = flax_layer_norm(x, self.final_norm.weight, self.final_norm.bias, dt)
        return dense(h, self.head_conv.weight, self.head_conv.bias, dt)


class UNet3D(nn.Module):
    """The classic conv-norm-act double-block 3D UNet (``bism_unet`` /
    ``unet``, JAX's ``unext.py:502-547``): each stage ``depth`` times a
    k^3 SAME conv (k = min(kernel_size, 3)), GroupNorm of min(8, dim)
    groups and the activation; 2^3 max pools down, the 2x trilinear
    upsample kernel up, the skip concatenated after it; a 1x1 head. Names
    are JAX's: ``enc{s}_conv{i}``, ``enc{s}_gn{i}``, ``bottleneck_*``,
    ``dec{s}_*``, ``head_conv``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 32,
                 dims: Sequence[int] = (32, 64, 128, 64, 32),
                 depths: Sequence[int] = (2, 2, 2, 2, 2), kernel_size: int = 3,
                 activation: str = "relu", dtype: torch.dtype = torch.bfloat16,
                 drop_path_rate: float = 0.0, layer_scale_init_value: float = 1.0,
                 device=None):
        # drop_path_rate and layer_scale_init_value: accepted as JAX's
        # UNet3D accepts them for the factory; the classic blocks use neither
        super().__init__()
        if len(dims) % 2 != 1 or len(depths) != len(dims):
            raise ValueError(f"dims {dims} / depths {depths}: need odd, equal lengths")
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: {list(_ACTIVATIONS)}")
        self.compute_dtype = dtype
        self.activation = activation
        self.dims, self.depths = list(dims), list(depths)
        kd = len(dims) // 2
        self.k_down = kd
        k = min(kernel_size, 3)

        def stage(name, din, dim, depth):
            for i in range(depth):
                self.add_module(f"{name}_conv{i}", Conv3D(din if i == 0 else dim, dim, k,
                                                          dtype, device))
                self.add_module(f"{name}_gn{i}", GroupNorm(dim, min(8, dim), dtype, device))
            return dim if depth else din

        c = in_channels
        for s in range(kd):
            c = stage(f"enc{s}", c, dims[s], depths[s])
        c = stage("bottleneck", c, dims[kd], depths[kd])
        for s in range(kd):
            d = kd + 1 + s
            c = stage(f"dec{s}", c + dims[kd - 1 - s], dims[d], depths[d])
        self.head_conv = Dense(c, out_channels, device)

    @staticmethod
    def pool(x: torch.Tensor) -> torch.Tensor:
        """The 2^3 max pool (stride 2) of the encoder."""
        return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1)

    def _stage(self, x, name, depth):
        for i in range(depth):
            x = getattr(self, f"{name}_conv{i}")(x)
            x = getattr(self, f"{name}_gn{i}")(x)
            x = activation(self.activation, x, self.compute_dtype)
        return x

    def forward(self, x: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``drop_gen`` is accepted for the factory's sake; UNet3D has no
        DropPath."""
        kd = self.k_down
        x = x.to(self.compute_dtype)
        skips = []
        for s in range(kd):
            x = self._stage(x, f"enc{s}", self.depths[s])
            skips.append(x)
            x = self.pool(x)
        x = self._stage(x, "bottleneck", self.depths[kd])
        for s in range(kd):
            x = upsample2x(x)
            x = torch.cat([x, skips[kd - 1 - s].to(x.dtype)], dim=-1)
            x = self._stage(x, f"dec{s}", self.depths[kd + 1 + s])
        return self.head(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 head conv (pointwise)."""
        return dense(x, self.head_conv.weight, self.head_conv.bias, self.compute_dtype)
