"""Depthwise k^3 SAME correlation plus bias on channels-last volumes.

Replaces ``skoots_tpu/kernels/dwconv.py::dwconv3d_pallas_v4`` (the TPU
production kernel; ``dwconv3d_pallas`` and ``dwconv3d_pallas_v6`` compute the
same function in older TPU layouts). The Hopper kernel is
``csrc/dwconv.cu``: FP32-FMA bound at k = 7 (343 taps per output), so it
stages a halo tile in shared memory and reuses each loaded column for all
k dz taps from registers (see the source header).

Numerics of both versions: the taps accumulate in f32, the bias is added in
f32, and the result rounds ONCE to the input dtype, as the Pallas kernel
does. (The JAX package's XLA path, which it uses off the TPU, rounds the
conv output before a bf16 bias add, so at bf16 it can differ from this by
one ulp per layer; at f32 they agree.)
"""

from __future__ import annotations

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


def dwconv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise conv: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (raises on what the kernel does not take)."""
    if x.device.type == "cpu":
        return dwconv3d_ref(x, w, b)
    _build.require_cuda(x, "dwconv3d")
    if x.ndim != 5 or w.ndim != 4 or w.shape[0] != w.shape[1] or w.shape[0] != w.shape[2]:
        raise ValueError(f"dwconv3d: x {tuple(x.shape)} / w {tuple(w.shape)}")
    bsz, xs, ys, zs, cin = x.shape
    k, c = w.shape[0], w.shape[-1]
    if cin not in (1, c) or k not in (3, 5, 7) or x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"dwconv3d: unsupported x {tuple(x.shape)} {x.dtype}, k={k}, C={c}")
    _build.check_operands("dwconv3d", x.device, w=(w, (k, k, k, c)), b=(b, (c,)))
    x = x.contiguous()
    w = w.detach().float().contiguous()
    b = b.detach().float().contiguous()
    out = torch.empty((bsz, xs, ys, zs, c), dtype=x.dtype, device=x.device)
    code = _build.library().skoots_dwconv3d(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, xs, ys, zs, c, k, cin, 1 if cin == c else 0,
        _build.stream_ptr(x))
    _build.check(code, "dwconv3d")
    dwconv3d.launches += 1
    return out


dwconv3d.launches = 0
