"""Shared-memory load + FMA rate of the card in the depthwise conv's access
pattern (``kernels/microbench.py::loadfma``): 343 taps per output column
over a [72, 16, 128] f32 buffer, static or dynamic source rows, 1 or 8
accumulator chains -- the four variants of the TPU tool.

    python -m skoots_tpu_torch.tools.bench_loadfma

Each variant runs once at the tool's size (one grid of 16 blocks, far from
filling the card) and with enough independent copies of the grid to fill
every SM several times. Each is checked exactly against the plain version
on integer-valued inputs (every product and partial sum is an exact f32
integer), then timed with CUDA events (median of ``repeats``); TFLOP/s
counts 2 flops per tap per lane. Prints one line per row and returns the
rows.
"""

from __future__ import annotations

import numpy as np
import torch

from skoots_tpu_torch.kernels.microbench import COLS, SHAPE, TAPS, loadfma, loadfma_ref
from skoots_tpu_torch.tools import median_ms

VARIANTS = (("static", False, 1), ("dynamic", True, 1), ("static_chains8", False, 8),
            ("dynamic_chains8", True, 8))


def fill_reps(device: torch.device) -> int:
    """Copies of the 16-block grid: three per SM (six blocks of 37 KB of
    shared memory fit an SM), so 8 waves of blocks."""
    return 3 * torch.cuda.get_device_properties(device).multi_processor_count


def measure(device=None, repeats: int = 5, seed: int = 0) -> list:
    """One row per (variant, reps): ``{"variant", "reps", "ms", "tflops",
    "flops"}``; raises if a kernel disagrees with its plain
    version."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_loadfma measures a CUDA card; none is available")
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(-8, 9, SHAPE).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.integers(-8, 9, (1, 128)).astype(np.float32)).to(device)
    rows = []
    for name, dynamic, chains in VARIANTS:
        want = loadfma_ref(buf, w, dynamic, chains)
        for reps in (1, fill_reps(device)):
            got = loadfma(buf, w, dynamic, chains, reps)
            torch.cuda.synchronize()
            mism = int((got != want[None]).sum())
            if mism:
                raise RuntimeError(f"loadfma {name} reps {reps}: {mism} values differ")
            ms = median_ms(lambda: loadfma(buf, w, dynamic, chains, reps), repeats)
            flops = float(reps) * COLS * TAPS * SHAPE[1] * SHAPE[2] * 2
            rows.append({"variant": name, "reps": reps, "ms": ms, "flops": flops,
                         "tflops": flops / ms / 1e9})
            print(f"loadfma {name} reps {reps}: {ms:.4f} ms "
                  f"{rows[-1]['tflops']:.2f} TFLOP/s (exact against the plain version)",
                  flush=True)
    return rows


def main() -> int:
    measure()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
