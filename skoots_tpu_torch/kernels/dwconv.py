"""Depthwise k^3 SAME correlation plus bias on channels-last volumes, and
its gradients.

Forward: replaces ``skoots_tpu/kernels/dwconv.py::dwconv3d_pallas_v4`` (the
TPU production kernel; ``dwconv3d_pallas`` and ``dwconv3d_pallas_v6``
compute the same function in older TPU layouts). The Hopper kernel is
``csrc/dwconv.cu``: at bf16 the k dz taps of each (dx, dy) are a 16x8
banded matrix, so the taps run on the tensor cores (exact bf16 products,
f32 sums; ``tests/test_torch_dwconv_banded.py`` states the decomposition);
at f32 an FP32-FMA kernel that reuses each staged column for the k dz taps
(see the source header).

Weight gradient: replaces ``dwconv3d_wgrad_pallas_v2`` (the TPU default)
and ``dwconv3d_wgrad_pallas`` (same function). The Hopper kernels are in
``csrc/dwconv_wgrad.cu``: at bf16 the transpose of the forward's banded
product on the tensor cores (each (dx, dy) a 16x8 product of input window
and cotangent whose diagonals are the k dz taps;
``tests/test_torch_wgrad_banded.py`` states it), the stem an implicit GEMM
with a Hankel input window; at f32 FP32 FMAs. Every block writes one row of
partial sums and a second launch adds the rows in a fixed order, so the
result does not change from run to run.

:func:`dwconv3d` is a ``torch.autograd.Function`` with the backward of the
JAX ``custom_vjp`` (``dwconv.py:182-221``): the input gradient is the
forward kernel on the cotangent with tap-flipped weights and no bias, the
weight gradient is :func:`dwconv3d_wgrad`, the bias gradient the f32 sum of
the cotangent; dw and db round to the compute dtype, as JAX's
``.astype(w.dtype)`` does.

The stem (a dense 1 -> C conv, run as this depthwise conv on the input
broadcast to C): every bf16 stem with C % 8 == 0, 8 <= C <= 256 and odd
k <= 15 runs an implicit GEMM on the tensor cores, forward and weight
gradient: the 32-channel templates at k = 3, 5, 7 (``stem_gemm_kernel``,
``stem_wgrad_tc_kernel``), every other such stem ``stem_gemm_chunk_kernel``
and ``stem_wgrad_chunk_kernel`` (N in chunks of at most 64 channels, 16 dz
lanes a group at k >= 9; ``tests/test_torch_stem_gemm.py`` states both).

Kernel sizes: every odd k >= 3, as JAX's schema takes. The depthwise
kernels are instantiated for k = 3, 5 and 7; a bf16 depthwise layer with
C % 8 == 0 at k = 9, 11, 13 or 15 runs ``dwconv3d_big_kernel`` and
``dwconv3d_wgrad_big_kernel`` (the banded products in one or two bands of
z taps, the forward's taps from a weight panel in shared memory, the
weight gradient's sums split into dy groups; ``tests/
test_torch_dwconv_bigk.py`` states both). Every other odd k (f32, bf16
without 16-byte channel groups, k > 15; and stems the GEMMs do not take:
f32, k > 15, C off the rule) runs a simple kernel with a run-time k,
forward (a thread an output value) and weight gradient (a thread a weight
entry of a partial row), f32 sums. The input gradient is the forward
kernel on the cotangent (a depthwise layer), so it takes the same k.
:func:`dwconv3d_route` and :func:`dwconv3d_wgrad_route` name the kernel a
launch takes.

Numerics of both forward versions: the taps accumulate in f32, the bias is
added in f32, and the result rounds ONCE to the input dtype, as the Pallas
kernel does. (The JAX package's XLA path, which it uses off the TPU, rounds
the conv output before a bf16 bias add, so at bf16 it can differ from this
by one ulp per layer; at f32 they agree.)
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from skoots_tpu_torch.kernels import _build


def dwconv3d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. ``x`` ``[B, X, Y, Z, C]`` (or ``[..., 1]`` with
    ``w`` of C channels: the one input channel broadcast to all C, the stem);
    ``w`` f32 ``[k, k, k, C]``; ``b`` f32 ``[C]``. Returns x's dtype."""
    c = w.shape[-1]
    k = w.shape[0]
    xf = x.float().expand(*x.shape[:-1], c).permute(0, 4, 1, 2, 3)
    wf = w.float().permute(3, 0, 1, 2).unsqueeze(1)  # [C, 1, k, k, k]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv3d(xf, wf, padding=k // 2, groups=c)
    y = y + b.float().view(1, c, 1, 1, 1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def dwconv3d_route(dt: torch.dtype, cin_stride: int, c: int, k: int) -> str | None:
    """The CUDA kernel a forward launch takes (``csrc/dwconv.cu::
    skoots_dwconv3d_route``) at dtype ``dt``, input channel stride
    ``cin_stride`` (0: the stem's one channel read for all ``c``; 1: a
    depthwise layer), ``c`` output channels and kernel size ``k``, by name
    (``"stem_gemm_chunk_kernel<9>"``), for contiguous 16-byte-aligned
    operands; None where the kernels refuse them. Builds the library:
    needs ``nvcc``."""
    return _build.route("skoots_dwconv3d_route", _build.DTYPE_CODES[dt], cin_stride, c, k)


def dwconv3d_wgrad_route(dt: torch.dtype, cin_stride: int, c: int, k: int) -> str | None:
    """The CUDA kernel a weight-gradient launch takes (``csrc/
    dwconv_wgrad.cu::skoots_dwconv3d_wgrad_route``), as
    :func:`dwconv3d_route` names the forward's."""
    return _build.route("skoots_dwconv3d_wgrad_route", _build.DTYPE_CODES[dt], cin_stride,
                        c, k)


def _check_conv_operands(what: str, x: torch.Tensor, c: int, k: int) -> None:
    if x.ndim != 5 or x.shape[-1] not in (1, c) or k < 3 or k % 2 == 0 \
            or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what}: unsupported x {tuple(x.shape)} {x.dtype}, "
                         f"k={k}, C={c}")


@_build.on_device
def _dwconv3d_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One forward launch (or the plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return dwconv3d_ref(x, w, b)
    _build.require_cuda(x, "dwconv3d")
    if w.ndim != 4 or w.shape[0] != w.shape[1] or w.shape[0] != w.shape[2]:
        raise ValueError(f"dwconv3d: x {tuple(x.shape)} / w {tuple(w.shape)}")
    k, c = w.shape[0], w.shape[-1]
    _check_conv_operands("dwconv3d", x, c, k)
    _build.check_operands("dwconv3d", x.device, w=(w, (k, k, k, c)), b=(b, (c,)))
    bsz, xs, ys, zs, cin = x.shape
    x = x.contiguous()
    if x.data_ptr() % 16 and dwconv3d_route(x.dtype, 1 if cin == c else 0, c, k).startswith(
            "dwconv3d_big_kernel<"):
        x = x.clone()  # it reads 16-byte channel groups
    w = w.float().contiguous()
    b = b.float().contiguous()
    out = torch.empty((bsz, xs, ys, zs, c), dtype=x.dtype, device=x.device)
    code = _build.library().skoots_dwconv3d(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, xs, ys, zs, c, k, cin, 1 if cin == c else 0,
        _build.stream_ptr(x))
    _build.check(code, "dwconv3d")
    dwconv3d.launches += 1
    return out


def dwconv3d_wgrad_ref(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch weight gradient: ``x`` ``[B, X, Y, Z, Cin]`` (Cin = 1
    broadcast to C, the stem; or C), ``g`` ``[B, X, Y, Z, C]``; returns f32
    ``[k, k, k, C]`` = ``sum_p xpad[p + d] * g[p]``, summed over the batch."""
    c = g.shape[-1]
    xf = x.float().expand(*x.shape[:-1], c).permute(0, 4, 1, 2, 3)
    gf = g.float().permute(0, 4, 1, 2, 3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        dw = torch.nn.grad.conv3d_weight(xf, (c, 1, k, k, k), gf,
                                         padding=k // 2, groups=c)
    return dw[:, 0].permute(1, 2, 3, 0).contiguous()


@_build.on_device
def dwconv3d_wgrad(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Depthwise weight gradient (f32 ``[k, k, k, C]``): the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor (raises on what the
    kernel does not take). The batch is summed inside the kernel."""
    if x.device.type == "cpu":
        return dwconv3d_wgrad_ref(x, g, k)
    _build.require_cuda(x, "dwconv3d_wgrad")
    c = g.shape[-1]
    _check_conv_operands("dwconv3d_wgrad", x, c, k)
    if g.dtype != x.dtype or g.shape[:-1] != x.shape[:-1] or g.device != x.device:
        raise ValueError(f"dwconv3d_wgrad: g {tuple(g.shape)} {g.dtype} on "
                         f"{g.device} against x {tuple(x.shape)} {x.dtype}")
    bsz, xs, ys, zs, cin = x.shape
    x = x.contiguous()
    g = g.contiguous()
    # the stems read g, the big-k kernel x and g, as 16-byte channel groups
    big = bool(x.data_ptr() % 16 or g.data_ptr() % 16) and dwconv3d_wgrad_route(
        x.dtype, 1 if cin == c else 0, c, k).startswith("dwconv3d_wgrad_big_kernel<")
    if (cin != c or big) and g.data_ptr() % 16:
        g = g.clone()
    if big and x.data_ptr() % 16:
        x = x.clone()
    lib = _build.library()
    dtype, cstride = _build.DTYPE_CODES[x.dtype], 1 if cin == c else 0
    # the launch plan depends on these alone (and the card): made once each
    key = (x.device.index, dtype, k, bsz, xs, ys, zs, c, cstride,
           x.data_ptr() % 16 == 0, g.data_ptr() % 16 == 0)
    plan = _WGRAD_PLANS.get(key)
    if plan is None:
        plan = (ctypes.c_int * _PLAN_INTS)()
        _build.check(lib.skoots_dwconv3d_wgrad_plan(dtype, x.data_ptr(), g.data_ptr(), bsz,
                                                     xs, ys, zs, c, k, cin, cstride, plan),
                     "dwconv3d_wgrad")
        _WGRAD_PLANS[key] = plan
    partial = torch.empty((plan[1], k * k * k, c), dtype=torch.float32, device=x.device)
    out = torch.empty((k, k, k, c), dtype=torch.float32, device=x.device)
    code = lib.skoots_dwconv3d_wgrad(
        dtype, x.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(), bsz, xs,
        ys, zs, c, k, cin, cstride, plan, _build.stream_ptr(x))
    _build.check(code, "dwconv3d_wgrad")
    dwconv3d_wgrad.launches += 1
    return out


dwconv3d_wgrad.launches = 0
# launch plans (int32 [_PLAN_INTS], csrc/dwconv_wgrad.cu::Plan; plan[1] the
# partial rows) by the operands they depend on
_PLAN_INTS = 12
_WGRAD_PLANS: dict = {}


class _DWConv3D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return _dwconv3d_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dt = x.dtype
        k, c = w.shape[0], w.shape[-1]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            zero = torch.zeros(c, dtype=torch.float32, device=g.device)
            dx = _dwconv3d_fwd(g, torch.flip(w, (0, 1, 2)), zero)
            if x.shape[-1] != c:  # the stem's broadcast input: sum over C
                dx = dx.float().sum(-1, keepdim=True)
            dx = dx.to(dt)
        if ctx.needs_input_grad[1]:
            dw = dwconv3d_wgrad(x, g, k).to(dt).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=tuple(range(g.ndim - 1))).to(dt).float()
        return dx, dw, db


def dwconv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable depthwise conv: the plain version for a CPU tensor,
    the CUDA kernels for a CUDA tensor, forward and backward (raises on what
    the kernels do not take). ``w`` and ``b`` are f32 tensors holding values
    of x's dtype (the model rounds them), so gradients round to it too."""
    return _DWConv3D.apply(x, w, b)


dwconv3d.launches = 0
