"""Data-derived knobs (numpy/scipy; copied from
``skoots_tpu/infer/autoknobs.py:34-110,254-286``).

Auto mode runs a few probe tiles with NO dilation, measures the minimum
spacing between sizeable connected components of the raw thresholded
skeleton, and picks the largest dilation stack that cannot bridge it.
Training stores :func:`estimate_object_radius` in the checkpoint.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# The reference's fixed stack: one 3D pass, two in-plane passes; used when
# the probe finds no separation evidence.
REFERENCE_STACK = (1, 2)


def estimate_skeleton_gap(
    skel: np.ndarray,
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
    min_component: int = 27,
    sample_cap: int = 4000,
) -> Optional[float]:
    """Minimum spacing (in XY-voxel units) between distinct sizeable
    connected components of an UNdilated thresholded skeleton map.

    Components below ``min_component`` voxels are ignored: they are
    prediction fragments — the very thing dilation exists to re-attach —
    not independent instances. Z distances are scaled by the relative
    anisotropy so an anisotropic stack's in-plane spacing dominates.
    Returns None when fewer than two sizeable components exist (no
    separation evidence).
    """
    from scipy import ndimage
    from scipy.spatial import cKDTree

    mask = np.asarray(skel) > 0
    if not mask.any():
        return None
    lab, n = ndimage.label(mask, structure=np.ones((3, 3, 3), bool))
    if n < 2:
        return None
    counts = np.bincount(lab.ravel())
    ids = np.nonzero(counts >= min_component)[0]
    ids = ids[ids != 0]
    if len(ids) < 2:
        return None

    az = float(anisotropy[2]) / max(float(anisotropy[0]), float(anisotropy[1]))
    coords = np.argwhere(mask)
    labels = lab[tuple(coords.T)]
    per_comp = []
    budget = max(8, sample_cap // len(ids))
    for i in ids:
        pts = coords[labels == i].astype(np.float64)
        stride = max(1, len(pts) // budget)
        pts = pts[::stride].copy()
        pts[:, 2] *= az
        per_comp.append(pts)

    gap = np.inf
    for i, pts in enumerate(per_comp):
        others = np.concatenate([p for j, p in enumerate(per_comp) if j != i])
        d, _ = cKDTree(others).query(pts, k=1)
        gap = min(gap, float(d.min()))
    return gap


def derive_dilation(
    gap_vox: Optional[float],
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
) -> Tuple[int, int]:
    """(dilation_3d, dilation_2d) from a measured skeleton spacing.

    Each dilation pass grows the mask by a Chebyshev-radius-1 ball (our
    max-pool dilation, ops/morphology.py), so a total in-plane radius
    ``r`` bridges two masks whose nearest voxels sit at distance
    ``<= 2r + 1``. The largest safe radius is therefore
    ``(gap - 2) // 2``, floored at 1 (radius 1 repairs 1-2 voxel
    fragmentation gaps, which outrank separation at that scale) and
    capped at the reference stack's total of 3. The single 3D pass is
    spent only when the data is near-isotropic in z (cfg
    SKOOTS.ANISOTROPY) and the budget allows in-plane radius >= 2 —
    matching every round-3 campaign regime (separated -> (1,2) =
    reference default; touching/aniso -> (0,1); crowded blobs -> (1,1)).
    """
    if gap_vox is None:
        return REFERENCE_STACK
    d_total = int(np.clip((gap_vox - 2) // 2, 1, 3))
    iso = float(anisotropy[2]) <= 1.5 * max(
        float(anisotropy[0]), float(anisotropy[1])
    )
    d3 = 1 if (iso and d_total >= 2) else 0
    return d3, d_total - d3


def estimate_object_radius(
    labels: np.ndarray, skeleton_points: dict | None = None
) -> Optional[float]:
    """Median EDT of the foreground at the skeleton points -- the object
    radius a checkpoint records at train time. ``skeleton_points``
    ``{instance_id: [N, 3]}``; without them the EDT ridge (values at or
    above the 80th percentile) stands in."""
    from scipy import ndimage

    fg = np.asarray(labels) > 0
    if not fg.any():
        return None
    edt = ndimage.distance_transform_edt(fg)
    if skeleton_points:
        vals = []
        shape = fg.shape
        for pts in skeleton_points.values():
            pts = np.asarray(pts)
            if pts.size == 0:
                continue
            ii = np.clip(np.round(pts).astype(int), 0, np.asarray(shape) - 1)
            vals.append(edt[ii[:, 0], ii[:, 1], ii[:, 2]])
        if vals:
            vals = np.concatenate(vals)
            vals = vals[vals > 0]
            if vals.size:
                return float(np.median(vals))
    ridge = edt[edt >= np.quantile(edt[fg], 0.8)]
    return float(np.median(ridge)) if ridge.size else None
