"""Connected components of the dilated skeleton mask.

Port of ``skoots_tpu/ops/flood_fill.py``. Every foreground voxel starts
with label = raveled index + 1 (int32); a round runs ``propagates_per_round``
masked max-propagation passes -- on a CUDA tensor the propagate kernel
(``kernels/propagate.py``) runs up to ``QMAX`` of them a launch
(``launch_plan``), on a CPU tensor its plain version one at a time -- then
``jumps_per_round`` pointer jumps ``L <- L[L - 1]`` (a plain
torch gather: union-find path halving, since labels are voxel addresses).
At the fixpoint each component carries the raveled index + 1 of its
maximum voxel.

* :func:`label_components` -- one tile, the host polling ``changed`` every
  round (``flood_fill.py:38``);
* :func:`make_label_components_stepped` -- the whole-volume schedule of the
  device pipeline (``flood_fill.py:296``), one host poll every
  ``rounds_per_dispatch`` rounds, each round optionally led by axis sweeps
  (:func:`_axis_run_max`, ``flood_fill.py:267``);
* :func:`label_components_sparse` -- the same labels from a union-find over
  the foreground point cloud (``flood_fill.py:138``), plain torch, with an
  ``ok`` flag that sends callers back to the dense engine;
* :func:`efficient_flood_fill` -- the host engine's tiled CC: each tile
  labelled on the device (dense, or sparse with a dense fallback per tile),
  compacted, offset into a disjoint id range, then a host union-find over
  every seam plane (``flood_fill.py:516``);
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


# voxels a whole-volume helper touches at once: its temporaries are slabs of
# this many voxels, never the volume
SLAB_VOXELS = 1 << 22


def _slabs(n: int):
    return ((s, min(s + SLAB_VOXELS, n)) for s in range(0, n, SLAB_VOXELS))


def _init_labels(binary: torch.Tensor):
    """(fg uint8, labels int32 = raveled index + 1 on fg, else 0). A
    contiguous uint8 ``binary`` serves as fg itself (any nonzero value is
    foreground), so only the labels are allocated."""
    x, y, z = binary.shape
    if x * y * z >= 2**31:
        raise ValueError("volume too large for int32 voxel addresses")
    if binary.dtype == torch.uint8 and binary.is_contiguous():
        fg = binary
    else:
        fg = (binary > 0).to(torch.uint8)
    labels = torch.arange(1, x * y * z + 1, dtype=torch.int32,
                          device=binary.device).view(x, y, z)
    return fg, labels.mul_(fg > 0)


def _one_round(fg: torch.Tensor, lab: torch.Tensor, connectivity: int,
               propagates: int, jumps: int) -> torch.Tensor:
    lab = propagate(lab, fg, passes=propagates, connectivity=connectivity)
    for _ in range(jumps):
        flat = lab.reshape(-1)
        tgt = (lab - 1).clamp_min(0).reshape(-1)
        lab = torch.where(lab > 0, flat[tgt].view(lab.shape), 0)
    return lab


def _jump_into(src: torch.Tensor, dst: torch.Tensor) -> None:
    """One pointer jump ``dst <- src > 0 ? src[src - 1] : 0``, slab by slab
    (``dst`` must not be ``src``: every gather reads the old labels)."""
    flat, out = src.view(-1), dst.view(-1)
    for s, e in _slabs(flat.numel()):
        seg = flat[s:e]
        torch.index_select(flat, 0, (seg - 1).clamp_min_(0), out=out[s:e])
        out[s:e].masked_fill_(seg == 0, 0)


def _label_sum(lab: torch.Tensor) -> torch.Tensor:
    """The labels' int64 sum (a device scalar), summed slab by slab."""
    flat = lab.view(-1)
    total = torch.zeros((), dtype=torch.int64, device=lab.device)
    for s, e in _slabs(flat.numel()):
        total += flat[s:e].sum(dtype=torch.int64)
    return total


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


def _axis_run_max(labels: torch.Tensor, fg: torch.Tensor, axis: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Each foreground voxel takes the max label of its whole contiguous run
    along ``axis`` (``flood_fill.py:267``): a segmented max scan, forward and
    reverse, in which every background voxel starts a segment (and counts
    in it, as in JAX's scan; its label is 0 in a CC). A segment's index is
    the running count of background voxels along the axis, which never
    decreases, so ``torch.cummax`` of the int64 key ``(segment << 32) |
    label`` is the segmented scan and its low 32 bits the label. Labels
    must be non-negative int32. Works in slabs of about ``SLAB_VOXELS``
    across another axis (the key, its cumulative maximum and indices take
    24 B a voxel); writes into ``out`` when given (not ``labels``)."""
    if out is None:
        out = torch.empty_like(labels)
    other = 0 if axis else 1
    n = labels.shape[other]
    per = max(1, SLAB_VOXELS // max(1, labels.numel() // max(n, 1)))

    def scan(lab, f):
        key = torch.cumsum(~f, axis, dtype=torch.int64).bitwise_left_shift_(32)
        key.bitwise_or_(lab.to(torch.int64))
        return torch.cummax(key, axis).values.bitwise_and_(0xFFFFFFFF)

    for s in range(0, n, per):
        lab = labels.narrow(other, s, min(per, n - s))
        f = fg.narrow(other, s, min(per, n - s)) > 0
        best = torch.maximum(scan(lab, f), scan(lab.flip(axis), f.flip(axis)).flip(axis))
        out.narrow(other, s, min(per, n - s)).copy_(best.masked_fill_(~f, 0))
    return out


def make_label_components_stepped(
    shape: Tuple[int, int, int],
    rounds_per_dispatch: int = 4,
    connectivity: int = 26,
    propagates_per_round: int = 1,
    jumps_per_round: int = 2,
    scans_per_round: int = 0,
):
    """Connected components with one host poll of ``changed`` every
    ``rounds_per_dispatch`` rounds. A round runs ``scans_per_round`` sweeps
    of :func:`_axis_run_max` along each axis (env ``SKOOTS_CC_SCANS``
    overrides it), then ``propagates_per_round`` propagation passes (the
    propagate kernel's ``len(launch_plan(propagates_per_round))`` launches
    on a card), then ``jumps_per_round`` pointer jumps. Returns
    ``label(binary, max_rounds) -> int32 labels``; ``label.last_rounds`` /
    ``label.last_converged`` report the rounds run and whether the fixpoint
    was reached."""
    return _stepped_labeller(shape, rounds_per_dispatch, connectivity,
                             propagates_per_round, jumps_per_round,
                             int(os.environ.get("SKOOTS_CC_SCANS", scans_per_round)))


def _stepped_labeller(shape, rounds_per_dispatch, connectivity, propagates_per_round,
                      jumps_per_round, scans_per_round):
    """:func:`make_label_components_stepped` with the schedule as given
    (no ``SKOOTS_CC_SCANS``), for callers that stand in for the JAX
    package's ``label_components``, which reads no such variable."""
    _check_connectivity(connectivity)
    if tuple(shape) and shape[0] * shape[1] * shape[2] >= 2**31:
        raise ValueError("volume too large for int32 voxel addresses")

    def label(binary: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
        # Two int32 volumes in all: the labels and one scratch buffer, which
        # the propagation takes as its second ping-pong buffer and the sweeps
        # and the jump as their output. Labels never decrease (a sweep or
        # pass takes a maximum that includes the voxel itself, a jump reads
        # the label of a voxel whose own label started at, and so is at
        # least, the one read), so a round changed nothing exactly when
        # their sum did not move.
        fg, labels = _init_labels(binary)
        scratch = torch.zeros_like(labels)
        total = _label_sum(labels)
        rounds = 0
        converged = False
        for _ in range(0, max_rounds, rounds_per_dispatch):
            for _ in range(rounds_per_dispatch):
                for _ in range(scans_per_round):
                    for ax in range(3):
                        _axis_run_max(labels, fg, ax, out=scratch)
                        labels, scratch = scratch, labels
                new = propagate(labels, fg, passes=propagates_per_round,
                                connectivity=connectivity, scratch=scratch)
                if new is scratch:
                    scratch = labels
                labels = new
                for _ in range(jumps_per_round):
                    _jump_into(labels, scratch)
                    labels, scratch = scratch, labels
            rounds += rounds_per_dispatch
            new_total = _label_sum(labels)
            changed = bool(new_total != total)
            total = new_total
            if not changed:
                converged = True
                break
        label.last_rounds = rounds
        label.last_converged = converged
        return labels

    label.last_rounds = None
    label.last_converged = None
    return label


def _forward_offsets(connectivity: int):
    if connectivity == 26:
        return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1) if (dx, dy, dz) > (0, 0, 0)]
    _check_connectivity(connectivity)
    return [(1, 0, 0), (0, 1, 0), (0, 0, 1)]


def label_components_sparse(binary: torch.Tensor, n_max: int,
                            max_rounds: int = 32, connectivity: int = 26):
    """Connected components of the foreground point cloud
    (``flood_fill.py:138``), step for step as the JAX package's: the
    ascending foreground indices (the first ``n_max``, padded with the
    volume's size), the 13 (26-connectivity) or 3 (6) forward neighbours
    of each found by binary search (a non-edge is a (0, 0) self-loop), the
    edge list compacted to ``4 * n_max``, then pointer-jump union-find
    rounds (hook to the max, two compressions) over the positions.

    Returns ``(labels, ok)``: int32 ``[X, Y, Z]`` labels in
    :func:`label_components`' convention (the raveled index + 1 of each
    component's maximum voxel; bit-identical to it when ``ok``), and
    ``ok``, a bool: False when the foreground overflowed ``n_max``, the
    edges ``4 * n_max``, or the rounds ended before the fixpoint -- callers
    then run the dense engine. One host poll a round;
    ``label_components_sparse.last_stats`` holds the foreground points,
    the edges found and the rounds run."""
    x, y, z = binary.shape
    total = x * y * z
    if total >= 2**31:
        raise ValueError("volume too large for int32 linear indexing")
    offs = _forward_offsets(connectivity)
    dev = binary.device
    flat = (binary > 0).reshape(-1)
    count = int(flat.sum())
    found = torch.nonzero(flat).squeeze(1)[:n_max].to(torch.int32)
    idx = torch.full((n_max,), total, dtype=torch.int32, device=dev)
    idx[:found.numel()] = found
    del found
    valid = idx < total
    cx = idx // (y * z)
    cy = (idx // z) % y
    cz = idx % z
    pos = torch.arange(n_max, dtype=torch.int32, device=dev)
    ea = torch.empty((len(offs), n_max), dtype=torch.int32, device=dev)
    eb = torch.empty_like(ea)
    for k, (dx, dy, dz) in enumerate(offs):
        nx, ny, nz = cx + dx, cy + dy, cz + dz
        inb = ((nx >= 0) & (nx < x) & (ny >= 0) & (ny < y) & (nz >= 0) & (nz < z)
               & valid)
        nkey = torch.where(inb, (nx * y + ny) * z + nz, -1)
        p = torch.searchsorted(idx, nkey, out_int32=True).clamp_(0, n_max - 1)
        match = inb & (idx.index_select(0, p) == nkey)
        ea[k] = pos.masked_fill(~match, 0)
        eb[k] = p.masked_fill_(~match, 0)
    del cx, cy, cz
    ea, eb = ea.view(-1), eb.view(-1)
    m_max = 4 * n_max
    em = (ea > 0) | (eb > 0)
    edge_count = int(em.sum())
    eidx = torch.zeros(m_max, dtype=torch.int64, device=dev)
    sel = torch.nonzero(em).squeeze(1)[:m_max]
    eidx[:sel.numel()] = sel
    del em, sel
    ea, eb = ea[eidx], eb[eidx]
    del eidx

    par = pos.clone()
    changed = True
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        pa, pb = par.index_select(0, ea), par.index_select(0, eb)
        lo, hi = torch.minimum(pa, pb).long(), torch.maximum(pa, pb)
        del pa, pb
        new = par.scatter_reduce(0, lo, hi, "amax")
        del lo, hi
        new = new.index_select(0, new)
        new = new.index_select(0, new)
        changed = bool((new != par).any())
        par = new
        if not changed:
            break

    out = torch.zeros(total, dtype=torch.int32, device=dev)
    keep = idx[valid].long()
    out[keep] = idx.index_select(0, par)[valid] + 1
    ok = count <= n_max and edge_count <= m_max and not changed
    label_components_sparse.last_stats = {"points": count, "edges": edge_count,
                                          "rounds": rounds}
    return out.view(x, y, z), ok


label_components_sparse.last_stats = None


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


def narrow_u16(labels: torch.Tensor) -> torch.Tensor:
    """int32 labels in [0, 2^16) as a uint16 tensor, built through int16:
    torch's kernels for uint16 are few, those for int16 complete."""
    return torch.where(labels > 32767, labels - 65536,
                       labels).to(torch.int16).view(torch.uint16)


def widen_u16(t: torch.Tensor) -> torch.Tensor:
    """A uint16 tensor (the thrifty pipeline's labels, a 16-bit EM volume)
    as int32, through its int16 view (:func:`narrow_u16`'s inverse). Any
    other tensor is returned as it is."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t


def _compact_labels(labels: torch.Tensor,
                    narrow16: bool = False) -> Tuple[torch.Tensor, int]:
    """Converged tile labels (raveled index + 1 of each component's maximum
    voxel, which alone points to itself) to 1..N in root order: a voxel's
    new label is the number of roots at or below its label, found by a
    binary search in the sorted root labels. Works in place, slab by slab,
    so no temporary spans the volume. Returns ``(compacted int32 labels,
    N)``; with ``narrow16`` and N < 2^16, the compacted labels go into a new
    int16 tensor instead, as uint16 bit patterns (``view(torch.uint16)``
    reads them)."""
    flat = labels.reshape(-1)
    if flat.numel() == 0:
        return labels, 0
    roots = []
    for s, e in _slabs(flat.numel()):
        seg = flat[s:e]
        iota = torch.arange(s + 1, e + 1, dtype=torch.int32, device=flat.device)
        roots.append(iota[seg == iota])
    roots = torch.cat(roots)
    n = int(roots.numel())
    out = flat
    if narrow16 and n < 2**16:
        out = torch.empty(flat.shape, dtype=torch.int16, device=flat.device)
    for s, e in _slabs(flat.numel()):
        seg = flat[s:e]
        comp = torch.searchsorted(roots, seg, right=True, out_int32=True)
        comp.masked_fill_(seg == 0, 0)
        out[s:e] = narrow_u16(comp).view(torch.int16) if out is not flat else comp
    return out.view(labels.shape), n


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
    returns at 16 bits. ``cc_impl`` (env ``SKOOTS_CC_IMPL``): ``"sparse"``
    labels each tile with :func:`label_components_sparse` (capacity from
    the crop, as the JAX package's) and falls back to the dense engine for
    a tile whose ``ok`` is False; anything else runs the dense engine.
    ``info`` receives ``max_label`` (a bound on the labels when compact,
    else None), ``rounds`` (dense CC rounds summed over the tiles; one
    propagation pass each), ``converged`` (every dense tile reached its
    fixpoint within ``max_rounds``; a tile that did not is labelled again
    without the bound, so the labels are exact either way, and
    ``unconverged_tiles`` counts those) and ``cc_tiles`` (tiles labelled by
    each engine). Returns the int32 labels.
    """
    device = torch.device(device)
    use_sparse = os.environ.get("SKOOTS_CC_IMPL", cc_impl) == "sparse"
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
    cc_n_max = max(1 << 14, (int(np.prod(crop)) // 32 + 8191) // 8192 * 8192)

    seams_per_axis: List[set] = [set(), set(), set()]
    next_label = 0  # running component count (compact mode only)
    rounds = 0
    unconverged = 0
    cc_tiles = {"sparse": 0, "dense": 0}
    with torch.no_grad():
        for t, origin in enumerate(origins):
            sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
            if pack_h2d:
                packed = np.packbits(np.asarray(skeleton[sl]) > 0, axis=-1)
                binary = _unpack_bits_dev(torch.from_numpy(packed).to(device))
            else:
                binary = torch.from_numpy(np.asarray(skeleton[sl]) > 0).to(device)
            engine = "dense"
            if use_sparse:
                labeled, ok = label_components_sparse(binary, n_max=cc_n_max)
                if ok:
                    engine = "sparse"
            if engine == "dense":
                labeled, done = label_components(binary, max_rounds=max_rounds,
                                                 return_converged=True)
                rounds += label_components.last_rounds
                if not done:
                    # a long thin path whose voxel order defeats the pointer
                    # jumps gains ~1 voxel a round: run it to its fixpoint,
                    # which comes within the tile's voxel count of rounds
                    unconverged += 1
                    labeled = label_components(binary, max_rounds=binary.numel())
                    rounds += label_components.last_rounds
            cc_tiles[engine] += 1
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
        info["converged"] = unconverged == 0
        info["unconverged_tiles"] = unconverged
        info["cc_tiles"] = cc_tiles
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


def _remap_chunks(x: np.ndarray, out: np.ndarray, to_replace: np.ndarray,
                  replace_with: np.ndarray, chunk: int = 8) -> None:
    """:func:`remap_labels` of ``x`` into ``out`` (``x`` itself for in
    place), ``chunk`` planes of axis 0 at a time: its int64 temporaries
    span a chunk, never the volume."""
    for i in range(0, x.shape[0], chunk):
        out[i : i + chunk] = remap_labels(np.asarray(x[i : i + chunk]),
                                          to_replace, replace_with)


def remap_labels_inplace(x: np.ndarray, to_replace: np.ndarray,
                         replace_with: np.ndarray, chunk: int = 8) -> None:
    """Chunked in-place remap along axis 0 (a memmap is never copied
    whole)."""
    _remap_chunks(x, x, to_replace, replace_with, chunk)


def _nonzero_labels(x: np.ndarray, chunk: int = 8) -> np.ndarray:
    """The sorted nonzero labels of ``x`` (int64), ``chunk`` planes at a
    time."""
    uniq = np.array([], dtype=np.int64)
    for i in range(0, x.shape[0], chunk):
        u = np.unique(np.asarray(x[i : i + chunk]))
        uniq = np.union1d(uniq, u[u != 0])
    return uniq


def renumber_inplace(x: np.ndarray, chunk: int = 8) -> int:
    """Compact labels to 1..N in place, chunk by chunk (bounded memory on
    memmaps). Returns N."""
    uniq = _nonzero_labels(x, chunk)
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
    instance size, 64)``. A memmap is changed in place; an in-memory array
    is copied only when something is dropped; both chunk by chunk. Returns
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
    out = x if isinstance(x, np.memmap) else np.empty_like(x)
    _remap_chunks(x, out, small, zeros, chunk)
    return out, int(small.size)


def renumber(x: np.ndarray, chunk: int = 8) -> Tuple[np.ndarray, Dict[int, int]]:
    """Compact labels to 1..N preserving 0 (fastremap.renumber equivalent),
    into a new int32 array, ``chunk`` planes of axis 0 at a time (the
    temporaries span a chunk: a whole-volume int64 remap would hold about
    34 B a voxel)."""
    x = np.asarray(x)
    uniq = _nonzero_labels(x, chunk)
    mapping = {int(u): i + 1 for i, u in enumerate(uniq)}
    if len(uniq) == 0:
        return x.astype(np.int32), {}
    out = np.empty(x.shape, np.int32)
    _remap_chunks(x, out, uniq, np.arange(1, len(uniq) + 1, dtype=np.int64), chunk)
    return out, mapping
