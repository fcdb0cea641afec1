"""The control's precision: float8 e4m3 with one scale a tensor.

The configurations state bfloat16; the nearest precision below it is fp8.
``fp8(t)`` scales ``t`` so its largest magnitude sits at e4m3's largest
finite value (448), rounds to e4m3 and scales back, in f32: the step a
later change that quantised the convolutions and matmuls to fp8 would take.
The reference applies it to both operands of every convolution and matmul
when it stands in as the control.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    s = amax / E4M3_MAX
    # the straight-through form keeps the control differentiable
    qv = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (qv - t).detach() if t.requires_grad else qv
