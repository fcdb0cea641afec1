"""Fused UNeXT head: LayerNorm -> 1x1 conv on channels-last volumes.

Replaces ``skoots_tpu/kernels/lnhead.py::_ln_head_call`` (body
``_kernel``). The Hopper kernel is ``csrc/lnhead.cu``: a memory-bound single
pass (read C, write N values per voxel), at bf16 with the products on the
tensor cores, at f32 on the FP32 pipe (see the source header). It takes
every width the JAX kernel takes (:func:`ln_head_eligible`) and any N: at
bf16 the tensor-core templates C = 16, 32, 64 and 128 with N <= 128, and a
tensor-core kernel with a run-time C in four width classes and N in
64-column chunks everything else; at f32 one kernel with a run-time C and
N chunked to fit W in shared memory. :func:`ln_head_route` names the kernel
a launch takes.

Numerics of both versions, as at ``lnhead.py:39-49``: LN statistics in f32
(eps 1e-6), the affine result rounded to the model dtype ``dt``, the matmul
accumulated in f32 and rounded to ``dt``, then the ``dt`` bias added and
rounded once more.

:func:`ln_head` is a ``torch.autograd.Function``: the forward runs the
kernel (the plain version on the CPU), the backward is the autograd of
:func:`xla_ln_head`, the plain composition the JAX ``custom_vjp``
differentiates (``lnhead.py:79-114``) -- never of :func:`ln_head_ref`, whose
one-product-at-a-time sum exists only to be the kernels' bit-exact
reference (the bf16 kernel sums on the tensor cores and recomputes in that
order the sums whose rounding the order could change).
"""

from __future__ import annotations

import torch

from skoots_tpu_torch.kernels import _build
from skoots_tpu_torch.kernels.mlp import (
    EPS,
    _rnd,
    layer_norm_rows,
    mlp_tail_eligible,
    recompute_grads,
)

# The JAX package's width rule for its fused LN head
# (``skoots_tpu/kernels/lnhead.py::ln_head_eligible``) is the block tail's,
# any N; the model runs flax's LayerNorm and 1x1 conv at every other width.
ln_head_eligible = mlp_tail_eligible


# the kernels a launch may take (csrc/lnhead.cu), as ln_head_route names
# them before their template arguments
HEAD_KERNELS = ("ln_head_tc_kernel", "ln_head_class_kernel", "ln_head_f32_kernel")


def ln_head_route(dt: torch.dtype, c: int, n: int) -> str | None:
    """The CUDA kernel a launch at dtype ``dt``, width ``c`` and ``n``
    outputs takes, by name (``csrc/lnhead.cu::skoots_ln_head_route``), or
    None where the kernels refuse the operands. Builds the library: needs
    ``nvcc``."""
    return _build.route("skoots_ln_head_route", _build.DTYPE_CODES[dt], c, n)


def _dot_in_order(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` as the kernel sums it: products added for k = 0, 1, ...,
    each product and sum rounded to f32 on its own (no FMA)."""
    acc = h[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + h[..., k:k + 1] * w[k]
    return acc


def ln_head_ref(x, ln_scale, ln_bias, w, b):
    """Plain PyTorch version: ``x`` ``[..., C]``, ``w`` ``[C, N]``, ``b``
    ``[N]``; returns ``[..., N]`` in x's dtype. The dot products add the
    products in order, as the kernels' FP32 steps do, so the kernels match
    it bit for bit."""
    dt = x.dtype
    h = layer_norm_rows(x, ln_scale, ln_bias, dt)
    y = _rnd(_dot_in_order(h, _rnd(w.float(), dt)), dt)
    return (y + _rnd(b.float(), dt)).to(dt)


def xla_ln_head(x, ln_scale, ln_bias, w, b, eps: float = EPS):
    """The JAX package's XLA composition (``lnhead.py::_xla_ln_head``) with
    the parameters cast to the model dtype as the model passes them; its
    autograd is the head's backward."""
    dt = x.dtype
    ls, lb, w, b = (t.to(dt) for t in (ln_scale, ln_bias, w, b))
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps)
    h = (h * ls.float() + lb.float()).to(dt)
    return torch.matmul(h, w) + b


@_build.on_device
def _ln_head_fwd(x, ln_scale, ln_bias, w, b):
    """One kernel launch (or the plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return ln_head_ref(x, ln_scale, ln_bias, w, b)
    _build.require_cuda(x, "ln_head")
    c = x.shape[-1]
    n = w.shape[-1]
    dt = x.dtype
    if not ln_head_eligible(c) or dt not in _build.DTYPE_CODES or w.ndim != 2 or n < 1:
        raise ValueError(f"ln_head: unsupported x {tuple(x.shape)} {dt}, w {tuple(w.shape)}")
    _build.check_operands("ln_head", x.device, ln_scale=(ln_scale, (c,)),
                          ln_bias=(ln_bias, (c,)), w=(w, (c, n)), b=(b, (n,)))
    x2 = x.contiguous().view(-1, c)
    if x2.data_ptr() % 16:  # the bf16 kernel reads 16-byte rows
        x2 = x2.clone()
    ls, lb, bb = (t.float().contiguous() for t in (ln_scale, ln_bias, b))
    wc = w.to(dt).contiguous()
    out = torch.empty((x2.shape[0], n), dtype=dt, device=x.device)
    code = _build.library().skoots_ln_head(
        _build.DTYPE_CODES[dt], x2.data_ptr(), ls.data_ptr(), lb.data_ptr(),
        wc.data_ptr(), bb.data_ptr(), out.data_ptr(), x2.shape[0], c, n, EPS,
        _build.stream_ptr(x))
    _build.check(code, "ln_head")
    ln_head.launches += 1
    return out.view(*x.shape[:-1], n)


class _LNHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _ln_head_fwd(*args)

    @staticmethod
    def backward(ctx, g):
        return recompute_grads(xla_ln_head, ctx.saved_tensors,
                               ctx.needs_input_grad, g)


def ln_head(x, ln_scale, ln_bias, w, b):
    """Differentiable fused LN + 1x1 head: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (raises on what the kernel
    does not take); the backward differentiates :func:`xla_ln_head`."""
    return _LNHead.apply(x, ln_scale, ln_bias, w, b)


ln_head.launches = 0
