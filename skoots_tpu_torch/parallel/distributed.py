"""Multi-process bootstrap (port of ``skoots_tpu/parallel/distributed.py``).

The port's meshes are driven by one process (``parallel/mesh.py``), so no
module of the port calls this, as none of the JAX package calls its
counterpart. It is the entry to a later multi-host version:
:func:`setup_process` joins a ``torch.distributed`` process group (NCCL on
CUDA, gloo on the CPU) at a ``tcp://`` rendezvous, and
:func:`broadcast_from_host0` shares a small host value from process 0 (the
reference's FileStore rank key-value role).
"""

from __future__ import annotations

import logging
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def find_free_port() -> int:
    """A free TCP port on this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        return s.getsockname()[1]


def setup_process(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the process group at ``tcp://<coordinator_address>``
    (``host:port``) as process ``process_id`` of ``num_processes``; backend
    ``nccl`` where CUDA is available, else ``gloo``. Returns this process's
    rank; 0, logging single-process mode, when the group cannot be
    initialised (no address given, or the rendezvous fails), as JAX's
    does. A process already in a group keeps it."""
    if dist.is_initialized():
        return dist.get_rank()
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("no coordinator address, process count and process id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    except (RuntimeError, ValueError) as e:
        log.info("torch.distributed not initialized (%s); single-process mode", e)
        return 0
    log.info("distributed: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(),
             backend)
    return dist.get_rank()


def cleanup() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def broadcast_from_host0(value) -> np.ndarray:
    """Process 0's ``value`` in every process (the same shape and dtype in
    each); the identity when no process group exists."""
    value = np.asarray(value)
    if not dist.is_initialized():
        return value
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    dist.broadcast(t, src=0)
    return t.cpu().numpy()
