"""Microbenchmarks of the card (``python -m skoots_tpu_torch.tools.<name>``):
``bench_fma_rate`` (FP32 / bf16 FMA rate) and ``bench_loadfma``
(shared-memory load + FMA rate in the depthwise conv's access pattern).
Both need a CUDA card."""

from __future__ import annotations

import numpy as np
import torch


def median_ms(fn, repeats: int) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn`` after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))
