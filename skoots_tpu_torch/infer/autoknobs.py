"""Data-derived knobs (numpy/scipy; copied from
``skoots_tpu/infer/autoknobs.py:34-110,123-228,230-286``).

Auto mode runs a few probe tiles with NO dilation, measures the minimum
spacing between sizeable connected components of the raw thresholded
skeleton, and picks the largest dilation stack that cannot bridge it.
A sparse checkpoint's semantic gate is calibrated on the inference volume
itself from the probe tiles' probability histogram
(:func:`calibrate_semantic_threshold_from_histogram`). Training stores
:func:`estimate_object_radius` in the checkpoint; sparse training checks
its ``DIST_THR`` against :func:`suggest_dist_thr_from_points` and records
the threshold of :func:`calibrate_semantic_threshold`.
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


def suggest_dist_thr(object_radius_vox: Optional[float]) -> Optional[float]:
    """Sparse training's ``DIST_THR`` suggestion: the embedding pull should
    reach across one object radius (rounded to 0.1 voxel). None without a
    radius estimate."""
    if object_radius_vox is None or object_radius_vox <= 0:
        return None
    return float(round(object_radius_vox, 1))


def suggest_dist_thr_from_points(skeletons: dict, sample_cap: int = 4000) -> Optional[float]:
    """Sparse training's ``DIST_THR`` suggestion from skeleton points alone:
    half the minimum spacing between points of DIFFERENT instances, the
    largest pull radius that cannot attract a voxel across the midline to
    another instance's skeleton. None with fewer than two instances."""
    from scipy.spatial import cKDTree

    pts = {k: np.asarray(v, np.float64) for k, v in skeletons.items()
           if k != 0 and np.asarray(v).size}
    if len(pts) < 2:
        return None
    budget = max(8, sample_cap // len(pts))
    sampled = []
    for v in pts.values():
        stride = max(1, len(v) // budget)
        sampled.append(v[::stride])
    gap = np.inf
    for i, p in enumerate(sampled):
        others = np.concatenate([q for j, q in enumerate(sampled) if j != i])
        d, _ = cKDTree(others).query(p, k=1)
        gap = min(gap, float(d.min()))
    return max(1.0, round(gap / 2.0, 1))


def sparse_target_fg_fraction(
    skeletons: dict,
    shape: Sequence[int],
    dist_thr: float,
    anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
) -> Optional[float]:
    """Fraction of a volume that sparse supervision declares foreground:
    the anisotropy-weighted ``dist_thr`` ball around the annotated points,
    the geometry the sparse embedding loss pulls toward. None without
    points."""
    from scipy import ndimage

    pts = [np.asarray(v) for v in skeletons.values() if np.asarray(v).size]
    if not pts:
        return None
    mask = np.ones(tuple(int(s) for s in shape), bool)
    ii = np.clip(np.round(np.concatenate(pts)).astype(int), 0, np.asarray(shape) - 1)
    mask[ii[:, 0], ii[:, 1], ii[:, 2]] = False
    edt = ndimage.distance_transform_edt(mask, sampling=[float(a) for a in anisotropy])
    return float((edt <= dist_thr).mean())


def calibrate_semantic_threshold(
    prob_values: np.ndarray,
    target_fg_frac: float,
    lo: float = 0.5,
    hi: float = 0.9999,
) -> float:
    """The semantic threshold whose foreground volume matches the
    supervision's: the ``1 - target_fg_frac`` quantile of the predicted
    probabilities, clamped to ``[lo, hi]`` so a degenerate probability map
    never disables the gate. Sparse training supervises the semantic head
    only through ``embed_prob > 0.2``, so the fixed 0.8 of dense
    checkpoints sits on the wrong side of its transition."""
    vals = np.asarray(prob_values, np.float32).ravel()
    frac = float(np.clip(target_fg_frac, 1e-6, 0.9))
    return float(np.clip(np.quantile(vals, 1.0 - frac), lo, hi))


def calibrate_semantic_threshold_from_histogram(
    probs: np.ndarray,
    lo: float = 0.5,
    bins: int = 128,
    min_count: int = 1000,
) -> Optional[float]:
    """Semantic threshold of a sparse checkpoint from the probability
    histogram of the inference volume, with no ground truth.

    True foreground saturates near 1.0, while the unsupervised "fat ring"
    just outside an object decays below it: in logit space a ring mode, a
    valley and a saturation spike. Otsu's split locates the region between
    the modes; the threshold is the smoothed histogram's minimum between
    the split and the saturation mode. Returns None when fewer than
    ``min_count`` values exceed ``lo`` (no foreground to calibrate on)."""
    vals = np.asarray(probs, np.float32).ravel()
    vals = vals[vals > lo]
    if vals.size < min_count:
        return None
    logit = np.log(np.clip(vals, 1e-6, 1 - 1e-7)) - np.log(
        np.clip(1 - vals, 1e-7, 1)
    )
    hist, edges = np.histogram(logit, bins=bins)
    centers = (edges[:-1] + edges[1:]) / 2
    kern = np.array([1.0, 4.0, 6.0, 4.0, 1.0])
    sm = np.convolve(hist.astype(np.float64), kern / kern.sum(), mode="same")

    tot = sm.sum()
    cum = np.cumsum(sm)
    cmean = np.cumsum(sm * centers)
    gmean = cmean[-1] / tot
    with np.errstate(divide="ignore", invalid="ignore"):
        between = (gmean * cum - cmean) ** 2 / (cum * (tot - cum))
    k = int(np.nanargmax(between))
    if k + 1 >= len(sm):
        return None
    m = k + 1 + int(np.argmax(sm[k + 1:]))  # saturation mode
    if m <= k + 1:
        t = centers[k]  # no room for a valley: Otsu's split stands
    else:
        t = centers[k + 1 + int(np.argmin(sm[k + 1:m]))]
    return float(1.0 / (1.0 + np.exp(-t)))


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
