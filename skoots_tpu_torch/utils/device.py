"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or the first CUDA card when none is given. Asking for CUDA
    where there is none raises: an entry point never carries on on the CPU
    unless the caller names it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but CUDA is not available; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    return dev
