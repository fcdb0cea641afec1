"""A ``('data', 'space')`` mesh of devices that one process drives.

Port of ``skoots_tpu/parallel/mesh.py``. The JAX package is single-controller:
one program lays a logical mesh over every chip, axis ``data`` for the batch
(data-parallel training) and axis ``space`` for the X axis of large
inference volumes. The port keeps that design with no process group: a
:class:`Mesh` is a ``[data][space]`` grid of ``torch.device``s, a sharded
tensor is a list of per-device pieces, and the callers
(``infer/sharded.py``, ``train/engine.py``) move data between pieces with
``tensor.to(device, non_blocking=True)``. Launches are asynchronous, so the
cards overlap while one thread drives them.

Unlike JAX's, a mesh may name one device more than once when the caller
passes ``devices`` (e.g. ``["cuda:0"] * 4`` or ``["cpu"] * 4``): the
multi-device code then runs on one device, which is how the CPU tests and a
one-card machine exercise it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


class Mesh:
    """``devices[d][s]``: the device of data row ``d`` and space column
    ``s``; ``shape`` ``{"data": D, "space": S}``, as ``jax.sharding.Mesh``'s."""

    axis_names = ("data", "space")

    def __init__(self, devices: List[List[torch.device]]):
        self.devices = devices
        self.shape = {"data": len(devices), "space": len(devices[0]) if devices else 0}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def _visible_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                           "(e.g. ['cpu'] * 4) to lay a mesh over other devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current card (the index tensors on it report)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    data: int = -1,
    space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a ('data', 'space') mesh. ``data=-1`` absorbs all remaining
    devices. ``devices`` defaults to every visible CUDA card; given
    explicitly, its entries (``torch.device`` or strings) may repeat."""
    devices = [_indexed(d) for d in devices] if devices is not None \
        else _visible_devices()
    n = len(devices)
    if data == -1:
        assert n % space == 0, f"{n} devices not divisible by space={space}"
        data = n // space
    assert data * space == n, f"mesh {data}x{space} != {n} devices"
    return Mesh([devices[d * space:(d + 1) * space] for d in range(data)])


def split_to(t: torch.Tensor, devices: Sequence, axis: int,
             bounds: Optional[Sequence[Tuple[int, int]]] = None) -> List[torch.Tensor]:
    """``t`` split along ``axis`` into one piece a device, piece ``i`` on
    ``devices[i]``: the planes ``bounds[i]`` (``(lo, hi)``, contiguous and
    in order) when given, else equal pieces, which the axis must divide (as
    JAX's ``NamedSharding`` requires)."""
    n = len(devices)
    if bounds is None:
        if t.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(t.shape)} is not divisible "
                             f"by {n} devices")
        per = t.shape[axis] // n
        bounds = [(i * per, (i + 1) * per) for i in range(n)]
    if len(bounds) != n:
        raise ValueError(f"{len(bounds)} pieces for {n} devices")
    out = []
    for (lo, hi), d in zip(bounds, devices):
        d = torch.device(d)
        out.append(t.narrow(axis, lo, hi - lo).to(d, non_blocking=d.type == "cuda"))
    return out


def batch_sharding(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """Axis 0 (batch) split over 'data': one piece a data row, on the row's
    first device. JAX replicates each piece over the 'space' axis, where
    the replicas change nothing; the port holds one copy a row."""
    return split_to(t, [row[0] for row in mesh.devices], 0)


def spatial_sharding(mesh: Mesh, t: torch.Tensor, axis: int = 1) -> List[List[torch.Tensor]]:
    """Axis ``axis`` split over 'space' and, for tensors of more than 3
    dimensions, axis 0 over 'data' (JAX's ``P('data', ..., 'space', ...)``):
    ``pieces[d][s]`` on ``mesh.devices[d][s]``. For channels-last volumes
    ``[B, X, Y, Z, C]`` use ``axis=1``."""
    rows = split_to(t, [t.device] * mesh.shape["data"], 0) if t.ndim > 3 else \
        [t] * mesh.shape["data"]
    return [split_to(r, devs, axis) for r, devs in zip(rows, mesh.devices)]


def replicated(mesh: Mesh, t: torch.Tensor) -> List[List[torch.Tensor]]:
    """``t`` on every device of the mesh: ``copies[d][s]`` (one tensor per
    distinct device; a repeated device shares it)."""
    on = {}
    for row in mesh.devices:
        for dev in row:
            if dev not in on:
                on[dev] = t.to(dev, non_blocking=dev.type == "cuda")
    return [[on[dev] for dev in row] for row in mesh.devices]
