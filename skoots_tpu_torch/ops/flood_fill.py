"""Connected components of the dilated skeleton mask.

Port of ``skoots_tpu/ops/flood_fill.py``. Every foreground voxel starts
with label = raveled index + 1 (int32); a round runs ``propagates_per_round``
masked max-propagation passes -- on a CUDA tensor each pass is one launch of
the propagate kernel (``kernels/propagate.py``), on a CPU tensor its plain
version -- then ``jumps_per_round`` pointer jumps ``L <- L[L - 1]`` (a plain
torch gather: union-find path halving, since labels are voxel addresses).
At the fixpoint each component carries the raveled index + 1 of its
maximum voxel.

* :func:`label_components` -- one tile, the host polling ``changed`` every
  round (``flood_fill.py:38``);
* :func:`make_label_components_stepped` -- the whole-volume schedule of the
  device pipeline (``flood_fill.py:296``), one host poll every
  ``rounds_per_dispatch`` rounds;
* :func:`efficient_flood_fill` -- the host engine's tiled CC: each tile
  labelled on the device, compacted, offset into a disjoint id range, then
  a host union-find over every seam plane (``flood_fill.py:516``);
* the host-side finishers ``drop_small_instances`` and ``renumber`` and
  their in-place, chunked forms for memmaps (numpy, copied).

Labels, compaction order and seam merges equal the JAX package's exactly;
the final renumber depends on label order.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from skoots_tpu_torch.kernels.propagate import propagate
from skoots_tpu_torch.ops.cropper import crop_origins, effective_crop_size


def _check_connectivity(connectivity: int) -> None:
    if connectivity not in (6, 26):
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")


def _init_labels(binary: torch.Tensor):
    x, y, z = binary.shape
    if x * y * z >= 2**31:
        raise ValueError("volume too large for int32 voxel addresses")
    fg = (binary > 0).to(torch.uint8)
    idx = torch.arange(1, x * y * z + 1, dtype=torch.int32,
                       device=binary.device).view(x, y, z)
    return fg, torch.where(fg > 0, idx, 0)


def _one_round(fg: torch.Tensor, lab: torch.Tensor, connectivity: int,
               propagates: int, jumps: int) -> torch.Tensor:
    lab = propagate(lab, fg, passes=propagates, connectivity=connectivity)
    for _ in range(jumps):
        flat = lab.reshape(-1)
        tgt = (lab - 1).clamp_min(0).reshape(-1)
        lab = torch.where(lab > 0, flat[tgt].view(lab.shape), 0)
    return lab


def label_components(
    binary: torch.Tensor,
    max_rounds: int = 64,
    connectivity: int = 26,
    propagates_per_round: int = 1,
    jumps_per_round: int = 2,
    return_converged: bool = False,
):
    """Label the connected components of a ``[X, Y, Z]`` mask on its device.
    Rounds stop at the fixpoint or after ``max_rounds``. Returns int32
    labels (0 background; the raveled index + 1 of each component's maximum
    voxel), with ``return_converged`` also whether the fixpoint was
    reached. ``label_components.last_rounds`` holds the rounds run."""
    _check_connectivity(connectivity)
    fg, labels = _init_labels(binary)
    changed = True
    rounds = 0
    for _ in range(max_rounds):
        new = _one_round(fg, labels, connectivity, propagates_per_round,
                         jumps_per_round)
        rounds += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    label_components.last_rounds = rounds
    if return_converged:
        return labels, not changed
    return labels


label_components.last_rounds = None


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
    _check_connectivity(connectivity)
    if tuple(shape) and shape[0] * shape[1] * shape[2] >= 2**31:
        raise ValueError("volume too large for int32 voxel addresses")

    def label(binary: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
        fg, labels = _init_labels(binary)
        rounds = 0
        converged = False
        for _ in range(0, max_rounds, rounds_per_dispatch):
            new = labels
            for _ in range(rounds_per_dispatch):
                new = _one_round(fg, new, connectivity, propagates_per_round,
                                 jumps_per_round)
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


def _seam_pairs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Unique (label_a, label_b) pairs of 26-adjacent voxels across a seam:
    ``a`` and ``b`` are the label planes on either side, and a voxel of
    ``a`` touches the 3x3 in-plane neighbourhood in ``b``."""
    out = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            bs = b
            if dy:
                bs = np.roll(bs, dy, axis=0)
                edge = slice(0, 1) if dy > 0 else slice(-1, None)
                bs = bs.copy()
                bs[edge, :] = 0
            if dz:
                bs = np.roll(bs, dz, axis=1)
                edge = slice(0, 1) if dz > 0 else slice(-1, None)
                bs = bs.copy()
                bs[:, edge] = 0
            m = (a > 0) & (bs > 0)
            if m.any():
                out.append(np.stack([a[m].ravel(), bs[m].ravel()], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.concatenate(out, axis=0).astype(np.int64), axis=0)


class _UnionFind:
    def __init__(self):
        self.parent: Dict[int, int] = {}

    def find(self, x: int) -> int:
        p = self.parent.setdefault(x, x)
        while p != self.parent.setdefault(p, p):
            self.parent[x] = self.parent[p]
            x, p = p, self.parent[p]
        return p

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _compact_labels(labels: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Converged tile labels (raveled index + 1 of each component's maximum
    voxel, which alone points to itself) to 1..N in root order: a cumsum
    ranks the roots, a gather at ``label - 1`` reads each voxel's rank.
    Returns ``(compacted int32 tile, N)``."""
    flat = labels.reshape(-1)
    if flat.numel() == 0:
        return labels, 0
    iota = torch.arange(1, flat.numel() + 1, dtype=torch.int32, device=flat.device)
    rank = torch.cumsum((flat == iota).to(torch.int32), 0, dtype=torch.int32)
    comp = torch.where(flat > 0, rank[(flat - 1).clamp_min(0).long()], 0)
    return comp.view(labels.shape), int(rank[-1])


def _unpack_bits_dev(packed: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of ``np.packbits(..., axis=-1)`` (big-endian bit
    order): ``[..., Z // 8]`` uint8 -> ``[..., Z]`` bool, so a binary tile
    crosses the host -> device wire at 1 bit per voxel."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8) > 0


def efficient_flood_fill(
    skeleton: np.ndarray,
    crop_size: Tuple[int, int, int] = (512, 512, 128),
    max_rounds: int = 64,
    relabel_sequential: bool = False,
    out: np.ndarray | None = None,
    compact: bool | None = None,
    cc_impl: str = "auto",
    wire_thrift: bool | None = None,
    info: dict | None = None,
    device="cuda",
) -> np.ndarray:
    """Tiled connected components of a host ``[X, Y, Z]`` binary (or >0)
    array (a memmap streams tile by tile) with each tile labelled on
    ``device`` and a host union-find over the seams.

    ``out``: optional preallocated int32 output (e.g. a memmap), written in
    place. ``compact``: compact each tile's labels to 1..n and offset by
    the running count (else tile t is offset by ``t * (prod(crop) + 1)``);
    ``None`` compacts when ``wire_thrift`` is on or the fast offsets would
    overflow int32. ``wire_thrift`` (default on; env ``SKOOTS_CC_WIRE=wide``
    turns it off): the binary tile crosses host -> device bit-packed when
    its Z is a multiple of 8, and a tile of fewer than 2^16 components
    returns at 16 bits. ``info`` receives ``max_label`` (a bound on the
    labels when compact, else None) and ``rounds`` (CC rounds summed over
    the tiles; one propagation pass each). Returns the int32 labels.
    """
    device = torch.device(device)
    cc_impl = os.environ.get("SKOOTS_CC_IMPL", cc_impl)
    if cc_impl not in ("auto", "dense"):
        raise NotImplementedError(
            f"cc_impl {cc_impl!r}: the sparse point-cloud CC is not ported to "
            "skoots_tpu_torch yet (see ROADMAP.md)")
    spatial = tuple(skeleton.shape)
    crop = effective_crop_size(spatial, crop_size)
    origins = crop_origins(spatial, crop, (0, 0, 0))
    if out is None:
        out = np.zeros(spatial, np.int32)
    elif tuple(out.shape) != spatial or out.dtype != np.int32:
        raise ValueError(f"out is {out.shape} {out.dtype}, expected {spatial} int32")
    tile_span = int(np.prod(crop)) + 1
    if wire_thrift is None:
        wire_thrift = os.environ.get("SKOOTS_CC_WIRE", "") != "wide"
    if compact is None:
        compact = wire_thrift or len(origins) * tile_span > 2**31 - 1
    pack_h2d = wire_thrift and crop[2] % 8 == 0

    seams_per_axis: List[set] = [set(), set(), set()]
    next_label = 0  # running component count (compact mode only)
    rounds = 0
    with torch.no_grad():
        for t, origin in enumerate(origins):
            sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
            if pack_h2d:
                packed = np.packbits(np.asarray(skeleton[sl]) > 0, axis=-1)
                binary = _unpack_bits_dev(torch.from_numpy(packed).to(device))
            else:
                binary = torch.from_numpy(np.asarray(skeleton[sl]) > 0).to(device)
            labeled = label_components(binary, max_rounds=max_rounds)
            rounds += label_components.last_rounds
            if compact:
                labeled, c = _compact_labels(labeled)
                if wire_thrift and c < 2**16:
                    # narrow device -> host: 16 bits, read back as unsigned
                    tile = (labeled.to(torch.int16).cpu().numpy().view(np.uint16)
                            .astype(np.int32))
                else:
                    tile = labeled.cpu().numpy().astype(np.int32)
                offset = next_label
                next_label += c
                if next_label >= 2**31 - 1:
                    raise RuntimeError(
                        f"instance count {next_label} exceeds int32 label range")
            else:
                tile = labeled.cpu().numpy().astype(np.int32)
                offset = t * tile_span
            if offset:
                np.add(tile, offset, out=tile, where=tile > 0)
            out[sl] = tile
            for ax in range(3):
                if origin[ax] > 0:
                    seams_per_axis[ax].add(origin[ax])

    # collisions across every seam plane
    uf = _UnionFind()
    for ax in range(3):
        for s in sorted(seams_per_axis[ax]):
            sl0 = [slice(None)] * 3
            sl1 = [slice(None)] * 3
            sl0[ax] = s
            sl1[ax] = s - 1
            for a, b in _seam_pairs(out[tuple(sl0)], out[tuple(sl1)]):
                uf.union(int(a), int(b))
    if uf.parent:
        keys = np.fromiter(uf.parent.keys(), dtype=np.int64)
        roots = np.array([uf.find(int(k)) for k in keys], dtype=np.int64)
        changed = keys != roots
        if changed.any():
            remap_labels_inplace(out, keys[changed], roots[changed])
    if info is not None:
        # seam merges only lower labels, so the pre-merge count bounds them
        info["max_label"] = next_label if compact else None
        info["rounds"] = rounds
    if relabel_sequential:
        renumber_inplace(out)
    return out


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


def remap_labels_inplace(x: np.ndarray, to_replace: np.ndarray,
                         replace_with: np.ndarray, chunk: int = 8) -> None:
    """Chunked in-place remap along axis 0 (a memmap is never copied
    whole)."""
    for i in range(0, x.shape[0], chunk):
        blk = np.asarray(x[i : i + chunk])
        x[i : i + chunk] = remap_labels(blk, to_replace, replace_with)


def renumber_inplace(x: np.ndarray, chunk: int = 8) -> int:
    """Compact labels to 1..N in place, chunk by chunk (bounded memory on
    memmaps). Returns N."""
    uniq = np.array([], dtype=np.int64)
    for i in range(0, x.shape[0], chunk):
        u = np.unique(np.asarray(x[i : i + chunk]))
        uniq = np.union1d(uniq, u[u != 0])
    if len(uniq) == 0:
        return 0
    vals = np.arange(1, len(uniq) + 1, dtype=np.int64)
    remap_labels_inplace(x, uniq, vals, chunk=chunk)
    return int(len(uniq))


def drop_small_instances(
    x: np.ndarray, min_size: int = -1, chunk: int = 8
) -> Tuple[np.ndarray, int]:
    """Zero instance ids whose voxel count is below a floor (speck filter).

    ``0`` disables; ``-1`` (auto) uses ``min(1% of the 75th-percentile
    instance size, 64)``. A memmap is changed in place, chunk by chunk;
    an in-memory array is copied only when something is dropped. Returns
    ``(mask, n_dropped)``.
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
    if isinstance(x, np.memmap):
        remap_labels_inplace(x, small, zeros, chunk=chunk)
        return x, int(small.size)
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
