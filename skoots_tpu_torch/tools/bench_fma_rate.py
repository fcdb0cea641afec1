"""FMA rate of the card: dependent ``x <- fma(x, a, b)`` chains of 512 x 16
steps (``kernels/microbench.py::fma_chain``), in f32 and bf16.

    python -m skoots_tpu_torch.tools.bench_fma_rate

Runs the TPU tool's shapes ((256, 128), (1024, 128), (64, 128): one chain
per thread, too few to fill the card) and a grid that fills every SM with 8
independent chains per thread. Each row is checked against the plain
version at a few steps, then timed with CUDA events (median of
``repeats``); TFLOP/s counts 2 flops per FMA. Prints one line per row and
returns the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from skoots_tpu_torch.kernels.microbench import N_ITER, UNROLL, fma_chain, fma_chain_ref
from skoots_tpu_torch.tools import median_ms

TOOL_SHAPES = ((256, 128), (1024, 128), (64, 128))
FILL_CHAINS = 8


def fill_elements(dtype: torch.dtype, device: torch.device) -> int:
    """Elements that give every SM 2048 threads of ``FILL_CHAINS`` chains
    (bf16: chains of element pairs)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * 2048 * FILL_CHAINS * (2 if dtype == torch.bfloat16 else 1)


def measure(device=None, repeats: int = 5, check_iters: int = 2, seed: int = 0) -> list:
    """One row per (dtype, shape): ``{"dtype", "shape", "chains", "ms",
    "tflops", "flops"}``; raises if a kernel disagrees with
    its plain version."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_fma_rate measures a CUDA card; none is available")
    rng = np.random.default_rng(seed)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(s, 1) for s in TOOL_SHAPES] + [((fill_elements(dtype, device),), FILL_CHAINS)]
        for shape, chains in cases:
            # check on random slopes near 1 at a few steps: exact. The plain
            # f32 chain rounds once per step, as fmaf; at bf16 these inputs
            # keep the f32 FMA exact (8-bit products of values within a few
            # binades), so rounding it to bf16 is the packed FMA's one rounding
            a = torch.from_numpy(rng.uniform(0.999, 1.001, shape).astype(np.float32))
            b = torch.from_numpy(rng.uniform(-1.0, 1.0, shape).astype(np.float32))
            a, b = a.to(device, dtype), b.to(device, dtype)
            got = fma_chain(a, b, check_iters, chains)
            want = fma_chain_ref(a, b, check_iters)
            torch.cuda.synchronize()
            mism = int((got != want).sum())
            if mism:
                raise RuntimeError(f"fma_chain {dtype} {shape}: {mism} values differ")
            # timing at the tool's constants
            a = torch.full(shape, 1.000001, dtype=dtype, device=device)
            b = torch.full(shape, 0.9999, dtype=dtype, device=device)
            ms = median_ms(lambda: fma_chain(a, b, N_ITER, chains), repeats)
            flops = float(np.prod(shape)) * N_ITER * UNROLL * 2
            rows.append({"dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
                         "chains": chains, "ms": ms, "flops": flops,
                         "tflops": flops / ms / 1e9})
            print(f"fma_rate {rows[-1]['dtype']} {tuple(shape)} chains {chains}: "
                  f"{ms:.4f} ms {rows[-1]['tflops']:.2f} TFLOP/s "
                  f"(check at {check_iters * UNROLL} steps: {mism} values differ)",
                  flush=True)
    return rows


def main() -> int:
    measure()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
