"""Masked label propagation for connected components:
``labels <- fg ? max over the 3^3 (26-conn) or 6-face + self neighbourhood
: 0``, with zero fill outside the volume, on int32 ``[X, Y, Z]`` labels.

Replaces ``skoots_tpu/kernels/propagate.py::propagate_pallas`` (Q passes per
call on VMEM x-slabs). The Hopper kernel is ``csrc/propagate.cu``: one
coalesced, shared-memory-tiled pass per launch, which this wrapper runs
``passes`` times over two ping-pong buffers (see the source header). The
result equals ``passes`` plain passes bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from skoots_tpu_torch.kernels import _build


def propagate_ref(labels: torch.Tensor, fg: torch.Tensor,
                  connectivity: int = 26) -> torch.Tensor:
    """One plain pass (separable shifted maxima; exact for int32)."""
    x, y, z = labels.shape
    p = F.pad(labels.unsqueeze(0), (1, 1, 1, 1, 1, 1)).squeeze(0)
    if connectivity == 26:
        t = torch.maximum(torch.maximum(p[:-2], p[2:]), p[1:-1])
        t = torch.maximum(torch.maximum(t[:, :-2], t[:, 2:]), t[:, 1:-1])
        t = torch.maximum(torch.maximum(t[:, :, :-2], t[:, :, 2:]), t[:, :, 1:-1])
    elif connectivity == 6:
        c = p[1:-1, 1:-1, 1:-1]
        t = torch.maximum(c, torch.maximum(p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1]))
        t = torch.maximum(t, torch.maximum(p[1:-1, :-2, 1:-1], p[1:-1, 2:, 1:-1]))
        t = torch.maximum(t, torch.maximum(p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:]))
    else:
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")
    return torch.where(fg > 0, t, torch.zeros((), dtype=t.dtype, device=t.device))


def propagate(labels: torch.Tensor, fg: torch.Tensor, passes: int = 4,
              connectivity: int = 26) -> torch.Tensor:
    """``passes`` propagation steps. ``labels`` int32 ``[X, Y, Z]``; ``fg``
    uint8 or bool ``[X, Y, Z]``. Plain passes for CPU tensors, the CUDA
    kernel (one launch per pass) for CUDA tensors."""
    if labels.device.type == "cpu":
        for _ in range(passes):
            labels = propagate_ref(labels, fg, connectivity)
        return labels
    _build.require_cuda(labels, "propagate")
    if labels.dtype != torch.int32 or labels.ndim != 3 or connectivity not in (6, 26):
        raise ValueError(f"propagate: unsupported labels {tuple(labels.shape)} "
                         f"{labels.dtype}, connectivity {connectivity}")
    _build.check_operands("propagate", labels.device, fg=(fg, labels.shape))
    fg = fg.to(torch.uint8).contiguous()
    src = labels.contiguous()
    bufs = [torch.empty_like(src), torch.empty_like(src) if passes > 1 else None]
    lib = _build.library()
    stream = _build.stream_ptr(src)
    x, y, z = src.shape
    for i in range(passes):
        dst = bufs[i % 2]
        code = lib.skoots_propagate(src.data_ptr(), fg.data_ptr(), dst.data_ptr(),
                                    x, y, z, connectivity, stream)
        _build.check(code, "propagate")
        propagate.launches += 1
        src = dst
    return src


propagate.launches = 0
