"""Per-slice 2D flood fill and stitching of a binary volume (port of
``skoots_tpu/utils/flood_and_stitch.py``, numpy and scipy on the host):
each plane is labelled with ``scipy.ndimage.label`` into a disjoint id
range, then every id of a plane is merged with its majority-overlap partner
in the next plane by one union-find."""

from __future__ import annotations

import logging

import numpy as np
from scipy.ndimage import label as nd_label

from skoots_tpu_torch.ops.flood_fill import _UnionFind, remap_labels, renumber

log = logging.getLogger(__name__)


def watershed_and_stitch(mask: np.ndarray, dim: int = 2) -> np.ndarray:
    """Label a binary ``[X, Y, Z]`` volume slice by slice along ``dim`` and
    stitch ids across adjacent slices by majority overlap. Returns the
    labels compacted to 1..N."""
    if mask.ndim != 3:
        raise ValueError(f"mask ndim must be 3, not {mask.shape}")
    if not 0 <= dim < 3:
        raise ValueError(f"dim must be 0..2, not {dim}")

    binary = mask > 0
    out = np.zeros(mask.shape, np.int64)
    n_slices = mask.shape[dim]

    def plane(i):
        idx = [slice(None)] * 3
        idx[dim] = i
        return tuple(idx)

    next_id = 1
    for i in range(n_slices):
        lab, n = nd_label(binary[plane(i)])
        out[plane(i)] = np.where(lab > 0, lab + (next_id - 1), 0)
        next_id += n

    if n_slices == 1:
        return renumber(out)[0]

    uf = _UnionFind()
    for i in range(1, n_slices):
        a = out[plane(i - 1)]
        b = out[plane(i)]
        both = (a > 0) & (b > 0)
        if not both.any():
            continue
        pairs, counts = np.unique(np.stack([a[both], b[both]], 1), axis=0,
                                  return_counts=True)
        # each id of slice a merges with its most-overlapping id of slice b
        order = np.lexsort((-counts, pairs[:, 0]))
        seen = set()
        for j in order:
            u = int(pairs[j, 0])
            if u in seen:
                continue
            seen.add(u)
            uf.union(u, int(pairs[j, 1]))

    if uf.parent:
        keys = np.fromiter(uf.parent.keys(), np.int64)
        roots = np.asarray([uf.find(int(k)) for k in keys], np.int64)
        ch = keys != roots
        if ch.any():
            out = remap_labels(out, keys[ch], roots[ch])

    out, _ = renumber(out)
    log.info("watershed_and_stitch: %d objects", len(np.unique(out)) - 1)
    return out
