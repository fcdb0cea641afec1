"""Masked label propagation for connected components:
``labels <- fg ? max over the 3^3 (26-conn) or 6-face + self neighbourhood
: 0``, with zero fill outside the volume, on int32 ``[X, Y, Z]`` labels.

Replaces ``skoots_tpu/kernels/propagate.py::propagate_pallas`` (Q passes per
call on VMEM x-slabs). The Hopper kernel is ``csrc/propagate.cu``: one
launch runs up to ``QMAX`` passes on tiles held with a ``QMAX``-voxel halo
in all three axes, and visits only the tiles whose interior has foreground,
listed once a call by a helper kernel (see the source header). This wrapper
runs :func:`launch_plan`'s launches over two ping-pong buffers that it
zeroes once a call, which is what makes the skip exact. The result equals
``passes`` plain passes bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from skoots_tpu_torch.kernels import _build

# passes one launch runs at most: the kernel's halo depth (PROP_QMAX in
# csrc/propagate.cu, which the library reports)
QMAX = 2


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


def launch_plan(passes: int, qmax: int = QMAX) -> list[int]:
    """Passes of each launch: ``qmax``-pass launches, then one remainder."""
    full, rest = divmod(passes, qmax)
    return [qmax] * full + ([rest] if rest else [])


@_build.on_device
def propagate(labels: torch.Tensor, fg: torch.Tensor, passes: int = 4,
              connectivity: int = 26, library=None,
              scratch: torch.Tensor | None = None) -> torch.Tensor:
    """``passes`` propagation steps. ``labels`` int32 ``[X, Y, Z]``; ``fg``
    uint8 or bool ``[X, Y, Z]``. Plain passes for CPU tensors, the CUDA
    kernel (``len(launch_plan(passes))`` launches) for CUDA tensors.
    ``library``: another build of ``csrc/propagate.cu`` to launch (its own
    tile and QMAX; ``tools/bench_propagate.py`` times candidates so).
    ``scratch``: an int32 buffer of ``labels``' shape, zero wherever ``fg``
    is; with it the launches ping-pong between ``scratch`` and contiguous
    ``labels`` (both overwritten; the result is one of them) and allocate
    no volume of their own."""
    if labels.device.type == "cpu":
        for _ in range(passes):
            labels = propagate_ref(labels, fg, connectivity)
        return labels
    _build.require_cuda(labels, "propagate")
    if labels.dtype != torch.int32 or labels.ndim != 3 or connectivity not in (6, 26):
        raise ValueError(f"propagate: unsupported labels {tuple(labels.shape)} "
                         f"{labels.dtype}, connectivity {connectivity}")
    _build.check_operands("propagate", labels.device, fg=(fg, labels.shape))
    lib = library or _build.library()
    plan = launch_plan(passes, lib.skoots_propagate_qmax())
    src = labels.contiguous()
    if not plan:
        return src
    fg = fg.to(torch.uint8).contiguous()
    x, y, z = src.shape
    stream = _build.stream_ptr(src)
    # the tiles with foreground, listed once (a helper kernel, not counted)
    n_tiles = lib.skoots_propagate_tile_count(x, y, z)
    if n_tiles < 0:
        raise ValueError(f"propagate: too many tiles in {tuple(src.shape)}")
    tiles = torch.empty(max(n_tiles, 1), dtype=torch.int32, device=src.device)
    count = torch.zeros(1, dtype=torch.int32, device=src.device)
    _build.check(lib.skoots_propagate_tiles(fg.data_ptr(), tiles.data_ptr(), count.data_ptr(),
                                            x, y, z, stream), "propagate tile list")
    # zeroed once: a launch writes only the listed tiles, and the others are
    # zero in every launch's output (fg is fixed within the call)
    if scratch is not None:
        # the labels are zero off fg, so they serve as the second buffer
        _build.check_operands("propagate", labels.device,
                              scratch=(scratch, labels.shape))
        if scratch.dtype != torch.int32 or not scratch.is_contiguous():
            raise ValueError("propagate: scratch must be contiguous int32")
        bufs = [scratch, src]
    else:
        bufs = [torch.zeros_like(src) for _ in range(min(len(plan), 2))]
    for i, q in enumerate(plan):
        dst = bufs[i % 2]
        code = lib.skoots_propagate(src.data_ptr(), fg.data_ptr(), dst.data_ptr(),
                                    tiles.data_ptr(), count.data_ptr(), x, y, z, q,
                                    connectivity, stream)
        _build.check(code, "propagate")
        propagate.launches += 1
        src = dst
    return src


propagate.launches = 0
