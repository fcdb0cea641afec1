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


def resolve_devices(device=None) -> tuple[torch.device, list[torch.device]]:
    """``(device, mesh devices)``: for a list or tuple of devices (or a
    comma-separated string), its first entry and the whole list (entries
    may repeat); otherwise :func:`resolve_device`'s device and, for a CUDA
    device, every visible card (``[device]`` for any other device)."""
    if isinstance(device, str) and "," in device:
        device = device.split(",")
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("an empty device list")
        devices = [resolve_device(d) for d in device]
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d for d in devices]
        return devices[0], devices
    dev = resolve_device(device)
    if dev.type == "cuda":
        return dev, [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return dev, [dev]
