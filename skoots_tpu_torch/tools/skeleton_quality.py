"""Skeleton quality of the ground-truth skeletonizers on shapes other than
tubes (port of ``tools/skeleton_quality.py``, names and row keys kept).

    python -m skoots_tpu_torch.tools.skeleton_quality
        [--out runs/skeleton_quality_torch.json]

Scores every method of ``train.generate_skeletons.calculate_skeletons``
(``medial``, ``lee``, ``teasar``) on three shapes -- a branching tube, a
curved thin sheet and an irregular blob -- with three metrics:

  coverage     share of the object's voxels whose nearest skeleton point
               lies within 1.5x the object's radius at that point (+2):
               the skeleton reaches every part of the object (the bake
               gives each voxel its nearest skeleton point as its target)
  centered     mean over the skeleton points inside the object of EDT(p)
               over the largest EDT in a 7x7x3 window: points sit on local
               depth maxima
  inside       share of the skeleton points strictly inside the object

Distances are anisotropic (z x3, the phantoms' geometry). Host only
(numpy, scipy and the host C++ Lee thinning); writes ``--out`` and prints
a table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
from scipy import ndimage

METHODS = ("medial", "lee", "teasar")


def branching_tube(shape=(96, 96, 32), radius=5) -> np.ndarray:
    """A Y: one trunk splitting into two arms, one of them tilting in z."""
    x, y, z = shape
    xx, yy, zz = np.meshgrid(np.arange(x), np.arange(y), np.arange(z), indexing="ij")
    d2 = np.full(shape, np.inf)
    segs = [
        ((10, 48, 16), (48, 48, 16)),   # trunk
        ((48, 48, 16), (86, 20, 16)),   # arm 1
        ((48, 48, 16), (86, 76, 24)),   # arm 2 (tilts in z)
    ]
    for a, b in segs:
        a, b = np.asarray(a, float), np.asarray(b, float)
        for t in np.linspace(0, 1, 48):
            p = a * (1 - t) + b * t
            np.minimum(d2, (xx - p[0]) ** 2 + (yy - p[1]) ** 2 + ((zz - p[2]) * 3.0) ** 2,
                       out=d2)
    return (d2 <= radius**2).astype(np.int32)


def flat_sheet(shape=(96, 96, 32)) -> np.ndarray:
    """A gently curved slab about 4 voxels thick in z: thinning should give
    a sheet-like point cloud, not one filament."""
    x, y, z = shape
    xx, yy, zz = np.meshgrid(np.arange(x), np.arange(y), np.arange(z), indexing="ij")
    mid = 16 + 4 * np.sin(xx / 14.0) * np.cos(yy / 18.0)
    m = (np.abs(zz - mid) <= 2) & (xx > 8) & (xx < 88) & (yy > 8) & (yy < 88)
    return m.astype(np.int32)


def irregular_blob(shape=(96, 96, 32)) -> np.ndarray:
    """One elongated blob of ``utils.synthetic.make_blobs`` (seed 11)."""
    from skoots_tpu_torch.utils.synthetic import make_blobs

    _, labels, _ = make_blobs(shape=shape, n_blobs=1, radius_range=(10, 14), seed=11,
                              elongation=2.0)
    return (labels > 0).astype(np.int32)


SHAPES = {
    "branching": branching_tube,
    "flat_sheet": flat_sheet,
    "blob": irregular_blob,
}


def score_skeleton(mask: np.ndarray, pts: np.ndarray, zscale: float = 3.0) -> dict:
    """The metrics above for one object's skeleton points ``pts`` ``[M, 3]``
    (z distances times ``zscale``), rounded to 3 places."""
    w = np.asarray([1.0, 1.0, zscale])
    edt = ndimage.distance_transform_edt(mask, sampling=w)
    vox = np.argwhere(mask > 0).astype(np.float32)

    # coverage: a voxel's distance to its nearest skeleton point against
    # the object's radius at that point (the voxel's own EDT would fail
    # every surface voxel)
    ip = np.clip(np.round(pts).astype(int), 0, np.asarray(mask.shape) - 1)
    at = edt[ip[:, 0], ip[:, 1], ip[:, 2]]
    d = np.empty(len(vox), np.float32)
    nearest = np.empty(len(vox), np.int64)
    for i in range(0, len(vox), 4096):
        d2 = (((vox[i:i + 4096, None, :] - pts[None, :, :]) * w) ** 2).sum(-1)
        nearest[i:i + 4096] = d2.argmin(1)
        d[i:i + 4096] = np.sqrt(d2.min(1))
    allow = 1.5 * np.maximum(at[nearest], 1.0) + 2.0
    coverage = float((d <= allow).mean())

    inside = float((at > 0).mean())
    local_max = ndimage.maximum_filter(edt, size=(7, 7, 3))
    ratio = at / np.maximum(local_max[ip[:, 0], ip[:, 1], ip[:, 2]], 1e-6)
    centered = float(ratio[at > 0].mean()) if (at > 0).any() else 0.0
    return {"coverage": round(coverage, 3), "centered": round(centered, 3),
            "inside": round(inside, 3), "n_points": int(len(pts))}


def quality_rows(shapes=None, methods=METHODS) -> dict:
    """``{shape: {method: score_skeleton row}}`` for ``shapes`` (name ->
    mask; default every shape of :data:`SHAPES` at its default size), the
    skeletons from ``calculate_skeletons(mask, scale=(1, 1, 3), method)``."""
    from skoots_tpu_torch.train.generate_skeletons import calculate_skeletons

    shapes = shapes if shapes is not None else {n: gen() for n, gen in SHAPES.items()}
    rows = {}
    for name, mask in shapes.items():
        rows[name] = {}
        for method in methods:
            skels = calculate_skeletons(mask, scale=(1.0, 1.0, 3.0), method=method)
            rows[name][method] = score_skeleton(mask, skels[1])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.skeleton_quality",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="runs/skeleton_quality_torch.json")
    args = ap.parse_args(argv)

    rows = quality_rows()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"{'shape':<12}{'method':<9}{'coverage':>9}{'centered':>9}{'inside':>8}"
          f"{'points':>8}")
    for name, by_m in rows.items():
        for method, r in by_m.items():
            print(f"{name:<12}{method:<9}{r['coverage']:>9}{r['centered']:>9}"
                  f"{r['inside']:>8}{r['n_points']:>8}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
