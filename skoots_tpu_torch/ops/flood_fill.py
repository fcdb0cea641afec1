"""Connected components of the dilated skeleton mask, on the device.

Port of ``skoots_tpu/ops/flood_fill.py::make_label_components_stepped``
(:296-434) with the main path's engine: every foreground voxel starts with
label = raveled index + 1 (int32); each round runs ``propagates_per_round``
masked max-propagation hops -- the CUDA propagate kernel
(``kernels/propagate.py``) in groups of 4, the plain single pass for the
remainder -- then ``jumps_per_round`` pointer jumps ``L <- L[L - 1]`` (a
plain torch gather: union-find path halving, since labels are voxel
addresses). The host polls ``changed`` once per round. At the fixpoint each
component carries the raveled index + 1 of its maximum voxel.

Also the host-side finishers ``drop_small_instances`` and ``renumber``
(numpy, copied from ``flood_fill.py:665-766``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref

PROPAGATE_Q = 4  # passes per kernel call, as the TPU kernel's Q


def make_label_components_stepped(
    shape: Tuple[int, int, int],
    rounds_per_dispatch: int = 4,
    connectivity: int = 26,
    propagates_per_round: int = 1,
    jumps_per_round: int = 2,
    scans_per_round: int = 0,
):
    """Connected components with one host poll of ``changed`` every
    ``rounds_per_dispatch`` rounds. Returns ``label(binary, max_rounds) ->
    int32 labels``; ``label.last_rounds`` / ``label.last_converged`` report
    the rounds run and whether the fixpoint was reached."""
    if scans_per_round:
        raise NotImplementedError(
            "the axis-scan CC schedule is not ported (see ROADMAP.md)")
    if connectivity not in (6, 26):
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")
    x, y, z = shape
    if x * y * z >= 2**31:
        raise ValueError("volume too large for int32 voxel addresses")
    n_calls, rem = divmod(propagates_per_round, PROPAGATE_Q)

    def one_round(fg: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        for _ in range(n_calls):
            lab = propagate(lab, fg, passes=PROPAGATE_Q, connectivity=connectivity)
        for _ in range(rem):
            lab = propagate_ref(lab, fg, connectivity)
        for _ in range(jumps_per_round):
            flat = lab.reshape(-1)
            tgt = (lab - 1).clamp_min(0).reshape(-1)
            lab = torch.where(lab > 0, flat[tgt].view(lab.shape), 0)
        return lab

    def label(binary: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
        fg = (binary > 0).to(torch.uint8)
        idx = torch.arange(1, x * y * z + 1, dtype=torch.int32,
                           device=binary.device).view(x, y, z)
        labels = torch.where(fg > 0, idx, 0)
        del idx
        rounds = 0
        converged = False
        for _ in range(0, max_rounds, rounds_per_dispatch):
            new = labels
            for _ in range(rounds_per_dispatch):
                new = one_round(fg, new)
            rounds += rounds_per_dispatch
            changed = bool((new != labels).any())
            labels = new
            if not changed:
                converged = True
                break
        label.last_rounds = rounds
        label.last_converged = converged
        return labels

    label.last_rounds = None
    label.last_converged = None
    return label


def remap_labels(
    x: np.ndarray, to_replace: np.ndarray, replace_with: np.ndarray
) -> np.ndarray:
    """Replace label values via a sorted-search lookup."""
    order = np.argsort(to_replace)
    keys = to_replace[order]
    vals = replace_with[order]
    pos = np.searchsorted(keys, x.ravel())
    pos = np.clip(pos, 0, len(keys) - 1)
    hit = keys[pos] == x.ravel()
    flat = np.where(hit, vals[pos], x.ravel())
    return flat.reshape(x.shape).astype(x.dtype)


def drop_small_instances(
    x: np.ndarray, min_size: int = -1, chunk: int = 8
) -> Tuple[np.ndarray, int]:
    """Zero instance ids whose voxel count is below a floor (speck filter).

    ``0`` disables; ``-1`` (auto) uses ``min(1% of the 75th-percentile
    instance size, 64)``. Returns ``(mask, n_dropped)``.
    """
    if min_size == 0:
        return x, 0
    counts: Dict[int, int] = {}
    for i in range(0, x.shape[0], chunk):
        u, c = np.unique(np.asarray(x[i : i + chunk]), return_counts=True)
        for uu, cc in zip(u[u != 0].tolist(), c[u != 0].tolist()):
            counts[int(uu)] = counts.get(int(uu), 0) + int(cc)
    if not counts:
        return x, 0
    if min_size < 0:
        p75 = float(np.percentile(
            np.fromiter(counts.values(), dtype=np.int64), 75))
        min_size = int(min(0.01 * p75, 64.0))
    small = np.array(
        sorted(k for k, v in counts.items() if v < min_size), dtype=np.int64
    )
    if small.size == 0:
        return x, 0
    zeros = np.zeros(small.size, dtype=np.int64)
    return remap_labels(x, small, zeros), int(small.size)


def renumber(x: np.ndarray) -> Tuple[np.ndarray, Dict[int, int]]:
    """Compact labels to 1..N preserving 0 (fastremap.renumber equivalent)."""
    uniq = np.unique(x)
    uniq = uniq[uniq != 0]
    mapping = {int(u): i + 1 for i, u in enumerate(uniq)}
    if len(uniq) == 0:
        return x.astype(np.int32), {}
    out = remap_labels(x.astype(np.int64), uniq.astype(np.int64),
                       np.arange(1, len(uniq) + 1, dtype=np.int64))
    return out.astype(np.int32), mapping
