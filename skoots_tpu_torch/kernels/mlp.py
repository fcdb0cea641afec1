"""Fused ConvNeXt block tail: LayerNorm -> pw1 -> GELU -> pw2 -> layer-scale
-> residual, C -> 4C -> C, on channels-last volumes.

Replaces ``skoots_tpu/kernels/mlp.py::_mlp_call`` (body ``_kernel``). The
Hopper kernel is ``csrc/mlp.cu``: the [V, 4C] hidden activation never
reaches device memory; at bf16 both GEMMs run on the tensor cores and the
erf-GELU epilogue on the FP32 pipe sets the pace, at f32 the GEMMs are
scalar FP32 FMAs (see the source header). It takes every width the JAX
kernel takes (:func:`mlp_tail_eligible`), each at bf16 on the tensor cores:
the templates at C = 16, 32, 64 and 128, a width-class kernel with a
run-time C at every other C <= 128, and above 128 a kernel whose warps
share row groups through a staged hidden chunk; at f32 one kernel with a
run-time C. :func:`mlp_tail_route` names the kernel a launch takes.

Rounding points of both versions, to the model dtype ``dt`` (identity at
f32), as at ``mlp.py:78-95`` of the TPU kernel: after the LayerNorm affine
(f32 statistics, eps 1e-6), after each matmul (f32 accumulation), after each
bias add, after the exact-erf GELU (computed in f32), after the layer-scale
multiply and after the residual add. The LN scale/bias, the biases and
gamma enter as ``dt`` values, as the Pallas kernel receives them.

:func:`mlp_block_tail` is a ``torch.autograd.Function``: the forward runs
the kernel (the plain version on the CPU), the backward is the autograd of
:func:`xla_tail`, the plain composition the JAX ``custom_vjp`` differentiates
(``mlp.py:130-173``), recomputed from the saved inputs.
"""

from __future__ import annotations

import math

import torch

from skoots_tpu_torch.kernels import _build

EPS = 1e-6  # flax nn.LayerNorm default


def mlp_tail_eligible(x) -> bool:
    """The JAX package's width rule for its fused block tail
    (``skoots_tpu/kernels/mlp.py::mlp_tail_eligible``): C % 8 == 0 and
    C <= 256. ``x`` is the channels-last ``[B, X, Y, Z, C]`` operand (as
    JAX's; another rank is not eligible) or its width C. Its volume
    conditions (a row tile that divides V, V >= 512) are not mirrored: the
    kernels here take any V. The model runs flax's plain composition at
    every other width, as JAX's does."""
    if hasattr(x, "shape"):
        if len(x.shape) != 5:
            return False
        x = x.shape[-1]
    return 0 < x <= 256 and x % 8 == 0


# the kernels a launch may take (csrc/mlp.cu), as mlp_tail_route names them
# before their template arguments
TAIL_KERNELS = ("tail_tc_kernel", "tail_class_kernel", "tail_staged_kernel", "tail_f32_kernel")


def mlp_tail_route(dt: torch.dtype, c: int) -> str | None:
    """The CUDA kernel a launch at dtype ``dt`` and width ``c`` takes, by
    name (``csrc/mlp.cu::skoots_mlp_tail_route``), or None where the
    kernels refuse the width. Builds the library: needs ``nvcc``."""
    return _build.route("skoots_mlp_tail_route", _build.DTYPE_CODES[dt], c)


def _rnd(t: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round an f32 tensor to ``dt`` and back to f32."""
    return t.to(dt).float()


def fold_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the CUDA kernels' warp order
    (``csrc/common.cuh::warp_fold_sum``): the 32-wide column blocks added
    left to right, then halving folds ``s[:h] + s[h:]`` down to one value.
    Zero padding to a multiple of 32 keeps any width exact."""
    c = v.shape[-1]
    if c % 32:
        v = torch.nn.functional.pad(v, (0, 32 - c % 32))
    s = v[..., 0:32]
    for i in range(1, v.shape[-1] // 32):
        s = s + v[..., 32 * i:32 * (i + 1)]
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    dt: torch.dtype, eps: float = EPS) -> torch.Tensor:
    """The TPU kernels' row LayerNorm in f32, rounded to ``dt`` (as f32):
    two-pass variance, every step in the CUDA kernels' order and rounding
    (``csrc/common.cuh::warp_layer_norm_any``)."""
    xf = x.float()
    # the width as a tensor: IEEE division on every device (a Python number
    # divides on CUDA as a multiply by its reciprocal, which differs from
    # the kernels' division wherever C is no power of two)
    c = xf.new_tensor(float(xf.shape[-1]))
    xc = xf - fold_sum(xf) / c
    var = fold_sum(xc * xc) / c
    inv = torch.sqrt(var + eps).reciprocal()
    return _rnd((xc * inv) * _rnd(scale.float(), dt) + _rnd(bias.float(), dt), dt)


def mlp_block_tail_ref(x, shortcut, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
    """Plain PyTorch version on ``[..., C]`` (``x`` the dwconv output,
    ``shortcut`` the block input); returns x's dtype."""
    dt = x.dtype
    h = layer_norm_rows(x, ln_scale, ln_bias, dt)
    a = _rnd(h @ _rnd(w1.float(), dt), dt)
    a = _rnd(a + _rnd(b1.float(), dt), dt)
    a = _rnd(0.5 * a * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0)))), dt)
    y = _rnd(a @ _rnd(w2.float(), dt), dt)
    y = _rnd(y + _rnd(b2.float(), dt), dt)
    y = _rnd(y * _rnd(gamma.float(), dt), dt)
    return (shortcut.float() + y).to(dt)


def xla_tail(x, shortcut, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
             eps: float = EPS):
    """The JAX package's XLA composition (``mlp.py::_xla_tail``) with the
    parameters cast to the model dtype as the block passes them: two-pass
    variance, f32 LN statistics, dt matmuls with f32 accumulation, dt bias
    adds. Its autograd is the block tail's backward."""
    dt = x.dtype
    ls, lb, w1, b1, w2, b2 = (t.to(dt) for t in (ln_scale, ln_bias, w1, b1, w2, b2))
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps)
    h = (h * ls.float() + lb.float()).to(dt)
    a = torch.matmul(h, w1) + b1
    a = torch.nn.functional.gelu(a.float()).to(dt)
    y = torch.matmul(a, w2) + b2
    return shortcut + y * gamma.to(dt)


@_build.on_device
def _mlp_fwd(x, shortcut, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
    """One kernel launch (or the plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return mlp_block_tail_ref(x, shortcut, ln_scale, ln_bias, w1, b1, w2,
                                  b2, gamma)
    _build.require_cuda(x, "mlp_block_tail")
    c = x.shape[-1]
    dt = x.dtype
    if not mlp_tail_eligible(c) or dt not in _build.DTYPE_CODES or shortcut.dtype != dt:
        raise ValueError(f"mlp_block_tail: unsupported x {tuple(x.shape)} {dt}")
    _build.check_operands(
        "mlp_block_tail", x.device, shortcut=(shortcut, x.shape),
        ln_scale=(ln_scale, (c,)), ln_bias=(ln_bias, (c,)), w1=(w1, (c, 4 * c)),
        b1=(b1, (4 * c,)), w2=(w2, (4 * c, c)), b2=(b2, (c,)), gamma=(gamma, (c,)))
    # the kernels read 16-byte rows (``out`` is a fresh allocation)
    x2, s2, w1c, w2c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (
        x.contiguous().view(-1, c), shortcut.contiguous().view(-1, c),
        w1.to(dt).contiguous(), w2.to(dt).contiguous()))
    # the five vectors rounded to dt in one buffer (three launches, not ten:
    # at small V the wrapper's launches cost more than the kernel)
    vec = _rnd(torch.cat([t.float() for t in (ln_scale, ln_bias, b1, b2, gamma)]), dt)
    vec = vec.split((c, c, 4 * c, c, c))
    out = torch.empty_like(x2)
    code = _build.library().skoots_mlp_tail(
        _build.DTYPE_CODES[dt], x2.data_ptr(), s2.data_ptr(),
        vec[0].data_ptr(), vec[1].data_ptr(), w1c.data_ptr(), vec[2].data_ptr(),
        w2c.data_ptr(), vec[3].data_ptr(), vec[4].data_ptr(), out.data_ptr(),
        x2.shape[0], c, EPS, _build.stream_ptr(x))
    _build.check(code, "mlp_block_tail")
    mlp_block_tail.launches += 1
    return out.view(x.shape)


def recompute_grads(composition, saved, needs, g):
    """Gradients of ``composition(*saved)`` for cotangent ``g``, w.r.t. the
    inputs flagged in ``needs`` (``None`` elsewhere): the backward of a
    kernel whose TPU ``custom_vjp`` differentiates an XLA composition."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = composition(*inputs)
        wrt = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, g)) if wrt else iter(())
    return tuple(next(grads) if n else None for n in needs)


class _MLPTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _mlp_fwd(*args)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(xla_tail, ctx.saved_tensors, ctx.needs_input_grad, g)


def mlp_block_tail(x, shortcut, ln_scale, ln_bias, w1, b1, w2, b2, gamma):
    """Differentiable fused block tail: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor (raises on what the kernel does not
    take); the backward differentiates :func:`xla_tail`."""
    return _MLPTail.apply(x, shortcut, ln_scale, ln_bias, w1, b1, w2, b2, gamma)


mlp_block_tail.launches = 0
