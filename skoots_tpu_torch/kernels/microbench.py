"""Two microbenchmarks of the card's arithmetic rates, beside their plain
PyTorch versions.

* :func:`fma_chain` replaces ``tools/bench_vpu_pallas.py::kernel``: every
  element runs ``iters * 16`` dependent steps ``x <- x * a + b`` from
  ``x = a`` (one rounding per step: a fused multiply-add), f32 or bf16.
* :func:`loadfma` replaces the four kernels of ``tools/bench_loadfma.py``:
  343 taps per output column over a ``[72, 16, 128]`` f32 buffer and a
  ``[1, 128]`` weight row, output ``[64, 16, 128]``, static or dynamic
  source rows, 1 or 8 accumulator chains.

The Hopper kernels are ``csrc/microbench.cu`` (see its header);
``skoots_tpu_torch/tools/bench_fma_rate.py`` and ``bench_loadfma.py`` time
them. Each wrapper takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from skoots_tpu_torch.kernels import _build
from skoots_tpu_torch.ops.vec2embed import fma

N_ITER = 512  # outer steps of the TPU tool
UNROLL = 16  # dependent steps per outer step
TAPS = 343
COLS = 64
SHAPE = (COLS + 8, 16, 128)  # source buffer
CHAINS = (1, 8)


def fma_chain_ref(a: torch.Tensor, b: torch.Tensor, iters: int = N_ITER) -> torch.Tensor:
    """Plain version: ``iters * 16`` steps of ``x <- fma(x, a, b)``. f32
    rounds each step once (the exact FMA of ``ops/vec2embed.py``); bf16
    rounds the f32 FMA to bf16, a second rounding the packed bf16 FMA does
    not make (exact wherever the f32 result holds a bf16 value)."""
    x = a
    for _ in range(iters * UNROLL):
        if a.dtype == torch.float32:
            x = fma(x, a, b)
        else:
            x = fma(x.float(), a.float(), b.float()).to(a.dtype)
    return x


@_build.on_device
def fma_chain(a: torch.Tensor, b: torch.Tensor, iters: int = N_ITER,
              chains: int = 1) -> torch.Tensor:
    """The FMA chain of every element of ``a`` (f32 or bf16, any shape; on
    the card the element count must be a multiple of ``chains`` (f32) or
    ``2 * chains`` (bf16 pairs)). ``chains`` (1 or 8) independent chains per
    thread change the schedule, not the result."""
    if a.device.type == "cpu":
        return fma_chain_ref(a, b, iters)
    _build.require_cuda(a, "fma_chain")
    if a.dtype not in _build.DTYPE_CODES or chains not in CHAINS or iters < 0:
        raise ValueError(f"fma_chain: unsupported {a.dtype}, chains={chains}, "
                         f"iters={iters}")
    _build.check_operands("fma_chain", a.device, b=(b, a.shape))
    a, b = a.contiguous(), b.to(a.dtype).contiguous()
    out = torch.empty_like(a)
    code = _build.library().skoots_fma_chain(
        _build.DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.numel(), iters, chains, _build.stream_ptr(a))
    _build.check(code, "fma_chain")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


def loadfma_ref(buf: torch.Tensor, w: torch.Tensor, dynamic: bool,
                chains: int) -> torch.Tensor:
    """Plain version of the tool's kernels: output column i is the sum over
    taps t of ``buf[row] * w[0, t % 128]``, row ``i + t % 8`` (dynamic) or
    ``t % 64`` (static); with 8 chains, tap t goes to chain t % 8 and the
    chains are summed pairwise, as the tool's loop builds it. Products and
    sums round separately, so at integer-valued inputs it is exact. Leading
    dimensions of ``buf`` are independent copies."""
    accs = [None] * chains
    lead, plane = buf.shape[:-3], buf.shape[-2:]
    for t in range(TAPS):
        r = t % 8 if dynamic else t % COLS
        src = (buf[..., r:r + COLS, :, :] if dynamic
               else buf[..., r:r + 1, :, :].expand(*lead, COLS, *plane))
        p = src * w[0, t % 128]
        c = t % chains
        accs[c] = p if accs[c] is None else accs[c] + p
    while len(accs) > 1:
        accs = [accs[n] + accs[n + 1] for n in range(0, len(accs) - 1, 2)] + (
            accs[-1:] if len(accs) % 2 else [])
    return accs[0]


@_build.on_device
def loadfma(buf: torch.Tensor, w: torch.Tensor, dynamic: bool, chains: int,
            reps: int = 1) -> torch.Tensor:
    """``[reps, 64, 16, 128]``: ``reps`` copies of the tool's output (on the
    card, ``reps`` independent grids that fill the SMs)."""
    if buf.device.type == "cpu":
        return loadfma_ref(buf, w, dynamic, chains)[None].expand(reps, COLS, *SHAPE[1:])
    _build.require_cuda(buf, "loadfma")
    if buf.dtype != torch.float32 or chains not in CHAINS or not 0 < reps < 65536:
        raise ValueError(f"loadfma: unsupported {buf.dtype}, chains={chains}, reps={reps}")
    _build.check_operands("loadfma", buf.device, buf=(buf, SHAPE), w=(w, (1, 128)))
    buf, w = buf.contiguous(), w.float().contiguous()
    out = torch.empty((reps, COLS, *SHAPE[1:]), dtype=torch.float32, device=buf.device)
    code = _build.library().skoots_loadfma(
        buf.data_ptr(), w.data_ptr(), out.data_ptr(), int(dynamic), chains, reps,
        _build.stream_ptr(buf))
    _build.check(code, "loadfma")
    loadfma.launches += 1
    return out


loadfma.launches = 0
