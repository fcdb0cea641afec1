"""Ground-truth skeletons for training (port of
``skoots_tpu/train/generate_skeletons.py``): ``skoots-torch
--skeletonize-train-data DIR`` writes a ``.skeletons.npz`` beside every
instance mask, one ``[M, 3]`` f32 array per instance id (string keys); the
original SKOOTS's ``.skeletons.trch`` is read with ``torch.load``.

Host preprocessing in numpy and scipy, run once per dataset; the Lee
thinning is host C++ (``csrc/host/lee_thin.cpp``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np
from scipy import ndimage

from skoots_tpu_torch.utils.io import imread
from skoots_tpu_torch.utils.lee_thin import lee_thin


def save_skeletons(path: str, skeletons: Dict[int, np.ndarray]) -> None:
    np.savez_compressed(path, **{str(k): v for k, v in skeletons.items()})


def load_skeletons(path: str) -> Dict[int, np.ndarray]:
    if path.endswith(".trch"):
        import torch

        d = torch.load(path, map_location="cpu", weights_only=False)
        return {int(k): np.asarray(v, np.float32) for k, v in d.items()}
    with np.load(path) as z:
        return {int(k): z[k].astype(np.float32) for k in z.files}


def _medial_points(binary: np.ndarray, nms_radius: float = 1.5) -> np.ndarray:
    """Medial-axis point cloud of a binary object: the ridge of its distance
    transform (local maxima), thinned by greedy non-maximum suppression in
    descending distance order, which leaves a near 1-voxel-wide chain."""
    edt = ndimage.distance_transform_edt(binary)
    if edt.max() == 0:
        return np.zeros((0, 3), np.float32)
    footprint = np.ones((3, 3, 3))
    local_max = ndimage.maximum_filter(edt, footprint=footprint)
    ridge = (edt >= local_max - 1e-6) & (edt >= 1.0)
    pts = np.argwhere(ridge)
    if len(pts) <= 1:
        return pts.astype(np.float32)

    from scipy.spatial import cKDTree

    vals = edt[tuple(pts.T)]
    order = np.argsort(-vals)
    tree = cKDTree(pts)
    alive = np.ones(len(pts), bool)
    keep = []
    for i in order:
        if not alive[i]:
            continue
        keep.append(i)
        for q in tree.query_ball_point(pts[i], r=nms_radius):
            alive[q] = False
    return pts[np.asarray(keep)].astype(np.float32)


def _lee_points(binary: np.ndarray) -> np.ndarray:
    """Skeleton point cloud of Lee-Kashyap-Chu 3D medial-axis thinning
    (host C++, ``utils/lee_thin.py``)."""
    return np.argwhere(lee_thin(binary)).astype(np.float32)


def _teasar_points(
    binary: np.ndarray,
    invalidation_scale: float = 3.0,
    invalidation_const: float = 2.0,
    pdrf_exponent: int = 8,
    pdrf_scale: float = 5000.0,
    max_paths: int = 512,
) -> np.ndarray:
    """TEASAR centerline point cloud of a binary object, with scipy:

    1. EDT of the object; per-voxel penalty ``pdrf_scale*(1-edt/max)^exp``
       steers paths onto the medial axis (the TEASAR "penalized distance from
       boundary" field).
    2. Root = geodesically furthest voxel from an arbitrary start.
    3. Repeatedly: Dijkstra over the penalty-weighted 26-connected voxel
       graph, walk the predecessor chain from the furthest still-valid voxel,
       append the path, invalidate all voxels within
       ``invalidation_scale*edt + invalidation_const`` of it.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    from scipy.spatial import cKDTree

    fg = np.argwhere(binary)
    n = fg.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.float32)
    if n == 1:
        return fg.astype(np.float32)

    edt = ndimage.distance_transform_edt(binary)
    idx_vol = np.full(binary.shape, -1, np.int64)
    idx_vol[tuple(fg.T)] = np.arange(n)

    # 26-connected adjacency over foreground voxels (13 half-offsets)
    offsets = [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) > (0, 0, 0)
    ]
    pen = pdrf_scale * (1.0 - edt[tuple(fg.T)] / max(edt.max(), 1e-6)) ** pdrf_exponent
    rows, cols, wts = [], [], []
    shape = np.asarray(binary.shape)
    for off in offsets:
        shifted = fg + off
        ok = np.all((shifted >= 0) & (shifted < shape), axis=1)
        src = np.arange(n)[ok]
        dst = idx_vol[tuple(shifted[ok].T)]
        hit = dst >= 0
        src, dst = src[hit], dst[hit]
        step = float(np.linalg.norm(off))
        w = step + 0.5 * (pen[src] + pen[dst])
        rows.append(src)
        cols.append(dst)
        wts.append(w)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    wts = np.concatenate(wts)
    graph = csr_matrix(
        (np.concatenate([wts, wts]), (np.concatenate([rows, cols]),
                                      np.concatenate([cols, rows]))),
        shape=(n, n),
    )

    # root: furthest (geodesic) voxel from an arbitrary start
    d0 = dijkstra(graph, indices=0)
    d0[~np.isfinite(d0)] = -1
    root = int(np.argmax(d0))
    dist, pred = dijkstra(graph, indices=root, return_predecessors=True)
    reachable = np.isfinite(dist)

    valid = reachable.copy()
    valid[root] = False
    tree = cKDTree(fg)
    radii = invalidation_scale * edt[tuple(fg.T)] + invalidation_const
    paths = [root]
    for _ in range(max_paths):
        if not valid.any():
            break
        masked = np.where(valid, dist, -np.inf)
        target = int(np.argmax(masked))
        path = []
        v = target
        while v != -9999 and v != root:
            path.append(v)
            v = int(pred[v])
        path.append(root)
        paths.extend(path)
        for p in path:
            for q in tree.query_ball_point(fg[p], r=float(radii[p])):
                valid[q] = False
    return fg[np.unique(np.asarray(paths))].astype(np.float32)


def calculate_skeletons(
    mask: np.ndarray,
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    method: str = "medial",
) -> Dict[int, np.ndarray]:
    """Skeleton points ``{id: [M, 3] f32}`` per instance of the ``[X, Y,
    Z]`` integer ``mask``. Each instance is cropped to its bounding box,
    upsampled by ``scale`` (nearest) when it is not all ones, and
    skeletonised by ``method``: ``"medial"`` (the distance transform's
    ridge), ``"lee"`` (Lee 3D thinning) or ``"teasar"`` (TEASAR
    centrelines). An instance with no skeleton point gets its centroid; the
    points map back through the zoom's voxel-centre inverse."""
    extractors = {"medial": _medial_points, "lee": _lee_points,
                  "teasar": _teasar_points}
    if method not in extractors:
        raise ValueError(f"unknown skeletonize method {method!r}")
    extract = extractors[method]
    scale = np.asarray(scale, np.float32)
    unique = np.unique(mask)
    unique = unique[unique != 0]
    out: Dict[int, np.ndarray] = {}

    upsample = not np.allclose(scale, 1.0)
    for uid in unique:
        binary = mask == uid
        nz = np.argwhere(binary)
        lower = nz.min(0)
        upper = nz.max(0) + 1
        crop = binary[lower[0]:upper[0], lower[1]:upper[1], lower[2]:upper[2]]
        if upsample:
            crop = ndimage.zoom(crop.astype(np.uint8), scale, order=0) > 0
        pts = extract(crop)
        if pts.shape[0] == 0:  # degenerate: centroid fallback
            pts = np.argwhere(crop).astype(np.float32).mean(0, keepdims=True)
        if upsample:
            # the voxel-centre inverse of the nearest zoom; a plain
            # ``pts / scale`` would push points out of thin objects
            pts = (pts + 0.5) / scale - 0.5
        out[int(uid)] = (pts + lower.astype(np.float32)).astype(np.float32)
    return out


def create_gt_skeletons(
    directory: str,
    mask_suffix: str = ".labels.tif",
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    method: str = "medial",
) -> None:
    """For every ``*<mask_suffix>`` in ``directory``, write its
    ``.skeletons.npz`` beside it."""
    files = sorted(glob.glob(os.path.join(directory, f"*{mask_suffix}")))
    for f in files:
        mask = imread(f).astype(np.int32)
        skels = calculate_skeletons(mask, scale, method=method)
        out = f.replace(mask_suffix, ".skeletons.npz")
        save_skeletons(out, skels)
        print(f"{f}: {len(skels)} skeletons -> {out}")


def save_train_test_split(
    mask: np.ndarray, skeletons: Dict[int, np.ndarray], z_split: int, base: str
) -> None:
    """Split skeletons by the Z plane ``z_split``: instances present at or
    below it go to ``<base>_train.skeletons.npz``, those at or above it to
    ``<base>_validate.skeletons.npz`` with Z shifted by ``-z_split``."""
    train_ids = np.unique(mask[..., : z_split + 1])
    val_ids = np.unique(mask[..., z_split:])
    save_skeletons(
        base + "_train.skeletons.npz",
        {int(u): skeletons[int(u)] for u in train_ids if u != 0 and int(u) in skeletons},
    )
    val = {}
    for u in val_ids:
        u = int(u)
        if u == 0 or u not in skeletons:
            continue
        pts = skeletons[u].copy()
        pts[:, 2] -= z_split
        val[u] = pts
    save_skeletons(base + "_validate.skeletons.npz", val)
