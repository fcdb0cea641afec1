"""Synthetic phantoms (port of ``skoots_tpu/utils/synthetic.py``).

``make_tubes`` and ``make_blobs`` (numpy, copied) make small volumes with
their instance masks and skeletons, ``apply_em_realism`` (numpy and scipy,
copied) degrades a clean phantom's image as EM is degraded;
``tube_segments`` (numpy, copied) places straight, well-separated tube
segments on the host and ``render_tubes`` rasterises them on the device in
torch, so a 512^3 phantom never exists on the host; ``perfect_prediction``
fabricates the ideal network output of a labelled volume with the port's
bake.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from skoots_tpu_torch.utils.device import resolve_device


def make_tubes(
    shape: Tuple[int, int, int] = (128, 128, 16),
    n_tubes: int = 4,
    radius: int = 5,
    seed: int = 101196,
    min_separation: float | None = None,
) -> Tuple[np.ndarray, np.ndarray, Dict[int, np.ndarray]]:
    """Random smooth tubes: ``(image u8 [X, Y, Z], labels int32 [X, Y, Z],
    skeletons {id: [M, 3] f32})``, the same arrays as the JAX package's
    ``make_tubes`` for the same arguments. ``min_separation``
    (centreline to centreline, voxels) redraws a tube up to 30 times until
    it keeps that distance from the tubes placed, and leaves it out after
    that; ``None`` lets tubes touch."""
    rng = np.random.default_rng(seed)
    x, y, z = shape
    labels = np.zeros(shape, np.int32)
    skeletons: Dict[int, np.ndarray] = {}

    xx, yy, zz = np.meshgrid(
        np.arange(x), np.arange(y), np.arange(z), indexing="ij"
    )
    kept_paths = []
    for tid in range(1, n_tubes + 1):
        # random smooth path along a random principal direction
        n_pts = max(x, y) // 2
        t = np.linspace(0, 1, n_pts)
        path = None
        for _attempt in range(30):
            start = rng.uniform(
                [radius + 1] * 3, [x - radius - 1, y - radius - 1, z - 2]
            )
            end = rng.uniform(
                [radius + 1] * 3, [x - radius - 1, y - radius - 1, z - 2]
            )
            wig = rng.normal(0, 2.0, (3, 3))
            cand = (
                start[None, :] * (1 - t[:, None])
                + end[None, :] * t[:, None]
                + np.stack(
                    [np.sin(t * np.pi * (k + 1)) for k in range(3)], 1
                ) @ wig
            )
            cand[:, 0] = np.clip(cand[:, 0], 1, x - 2)
            cand[:, 1] = np.clip(cand[:, 1], 1, y - 2)
            cand[:, 2] = np.clip(cand[:, 2], 1, z - 2)
            if min_separation is None or not kept_paths:
                path = cand
                break
            d = min(
                float(
                    np.sqrt(
                        ((cand[:, None, :] - p[None, :, :]) ** 2).sum(-1)
                    ).min()
                )
                for p in kept_paths
            )
            if d >= min_separation:
                path = cand
                break
        if path is None:
            continue  # could not place without touching; fewer tubes is fine
        kept_paths.append(path)
        skeletons[tid] = path.astype(np.float32)

        # paint the tube: distance to the polyline under z-anisotropy
        d2min = np.full(shape, np.inf)
        for p in path[:: max(1, n_pts // 32)]:
            d2 = (xx - p[0]) ** 2 + (yy - p[1]) ** 2 + ((zz - p[2]) * 3.0) ** 2
            np.minimum(d2min, d2, out=d2min)
        tube = d2min <= radius**2
        labels[tube & (labels == 0)] = tid

    img = np.full(shape, 40.0)
    img += (labels > 0) * 120.0
    img += np.random.default_rng(seed + 1).normal(0, 12.0, shape)
    image = np.clip(img, 0, 255).astype(np.uint8)
    return image, labels, skeletons


def make_blobs(
    shape: Tuple[int, int, int] = (128, 128, 32),
    n_blobs: int = 12,
    radius_range: Tuple[int, int] = (6, 14),
    seed: int = 101196,
    min_separation: float = 4.0,
    elongation: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray, Dict[int, np.ndarray]]:
    """Mito-like ellipsoidal blobs with random orientation and bumpy radius.

    Unlike :func:`make_tubes`, blobs are compact (low aspect) — the regime
    where skeletons degenerate toward centroids/short medial segments (the
    reference's degenerate-object fallback, generate_skeletons.py:148-151).
    Returns (image u8, labels int32, skeletons {id: [M, 3]}) where each
    skeleton is the blob's medial segment (its long axis, shrunk to the
    interior).
    """
    rng = np.random.default_rng(seed)
    x, y, z = shape
    labels = np.zeros(shape, np.int32)
    skeletons: Dict[int, np.ndarray] = {}
    xx, yy, zz = np.meshgrid(
        np.arange(x), np.arange(y), np.arange(z), indexing="ij"
    )
    centers = []
    tid = 0
    for _ in range(n_blobs * 8):
        if tid >= n_blobs:
            break
        r = float(rng.uniform(*radius_range))
        c = rng.uniform(
            [r + 1, r + 1, max(2.0, r / 3)],
            [x - r - 1, y - r - 1, z - max(2.0, r / 3)],
        )
        if centers and min(
            np.linalg.norm((c - np.asarray(o[0])) / np.asarray([1, 1, 1]))
            - r - o[1]
            for o in centers
        ) < min_separation:
            continue
        centers.append((c, r))
        tid += 1
        # random orientation; squash z by the anisotropy factor 3
        axis = rng.normal(size=3)
        axis[2] *= 0.3
        axis /= np.linalg.norm(axis) + 1e-9
        lon = r * float(rng.uniform(1.2, elongation))
        d = np.stack([xx - c[0], yy - c[1], (zz - c[2]) * 3.0], -1)
        along = d @ axis
        perp2 = (d * d).sum(-1) - along**2
        bump = 1.0 + 0.25 * np.sin(xx * 0.7 + tid) * np.sin(yy * 0.9 - tid)
        blob = (along / lon) ** 2 + perp2 / (r * bump) ** 2 <= 1.0
        labels[blob & (labels == 0)] = tid
        # medial segment along the long axis (interior 60%)
        t = np.linspace(-0.6, 0.6, 9)[:, None]
        pts = c[None, :] + t * lon * (axis * np.asarray([1.0, 1.0, 1 / 3.0]))[None, :]
        pts[:, 0] = np.clip(pts[:, 0], 1, x - 2)
        pts[:, 1] = np.clip(pts[:, 1], 1, y - 2)
        pts[:, 2] = np.clip(pts[:, 2], 1, z - 2)
        skeletons[tid] = pts.astype(np.float32)

    img = np.full(shape, 40.0)
    img += (labels > 0) * 120.0
    img += np.random.default_rng(seed + 1).normal(0, 12.0, shape)
    image = np.clip(img, 0, 255).astype(np.uint8)
    return image, labels, skeletons


def apply_em_realism(
    image: np.ndarray,
    labels: np.ndarray,
    seed: int = 0,
    texture: float = 0.35,
    gradient: float = 0.25,
    distractors: int = 10,
    distractor_contrast: float = 0.55,
    psf_sigma: Tuple[float, float, float] = (0.8, 0.8, 0.4),
    noise: float = 6.0,
) -> np.ndarray:
    """EM-plausible degradation of a clean phantom image.

    The clean generators paint uniform-intensity instances over uniform
    background + white noise — far easier than real EM, whose organelles
    are textured, unevenly illuminated, surrounded by membranes of similar
    contrast, and blurred anisotropically by the imaging PSF. This applies,
    in order: band-limited multiplicative texture (stronger inside
    instances), a smooth illumination gradient along a random direction,
    membrane-like distractor sheets in the BACKGROUND at
    ``distractor_contrast`` of the fg-bg contrast (structures a naive
    intensity threshold would swallow), an anisotropic gaussian PSF, and
    fine noise. Labels are untouched — realism degrades the image, not the
    ground truth. Returns the degraded u8 image.
    """
    from scipy import ndimage as ndi

    rng = np.random.default_rng(seed)
    img = np.asarray(image, np.float32).copy()
    labels = np.asarray(labels)
    fg = labels > 0
    x, y, z = img.shape

    # 1. band-limited texture, multiplicative (EM organelle interiors are
    # granular; background cytosol less so)
    t = ndi.gaussian_filter(
        rng.normal(0, 1, img.shape).astype(np.float32), (3.0, 3.0, 1.5)
    )
    t /= max(float(t.std()), 1e-6)
    img = img * (1.0 + np.where(fg, 0.5 * texture, 0.2 * texture) * t)

    # 2. smooth illumination gradient along a random direction
    d = rng.normal(size=3)
    d /= np.linalg.norm(d) + 1e-9
    xx, yy, zz = np.meshgrid(
        np.arange(x, dtype=np.float32), np.arange(y, dtype=np.float32),
        np.arange(z, dtype=np.float32), indexing="ij",
    )
    proj = xx * d[0] + yy * d[1] + zz * d[2]
    proj = (proj - proj.min()) / (np.ptp(proj) + 1e-6) - 0.5
    img = img * (1.0 + gradient * proj)

    # 3. membrane-like distractor sheets (background only): gently curved
    # thin surfaces at a contrast between bg and fg
    fg_mean = float(img[fg].mean()) if fg.any() else 160.0
    bg_mean = float(img[~fg].mean()) if (~fg).any() else 40.0
    memb_val = bg_mean + distractor_contrast * (fg_mean - bg_mean)
    for _ in range(distractors):
        n = rng.normal(size=3)
        n[2] *= 0.5  # sheets mostly cut across the thin axis shallowly
        n /= np.linalg.norm(n) + 1e-9
        amp = rng.uniform(2.0, 8.0)
        wx, wy = rng.uniform(0.02, 0.08, 2)
        phase = rng.uniform(0, 2 * np.pi)
        s = (xx * n[0] + yy * n[1] + zz * n[2]
             + amp * np.sin(wx * xx + wy * yy + phase))
        c = rng.uniform(s.min(), s.max())
        h = rng.uniform(0.8, 1.6)
        sheet = (np.abs(s - c) < h) & ~fg
        img[sheet] = memb_val

    # 4. anisotropic PSF + 5. fine noise
    img = ndi.gaussian_filter(img, psf_sigma)
    img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def tube_segments(
    shape: Tuple[int, int, int],
    n_tubes: int,
    radius: float = 5.0,
    seed: int = 7,
    min_separation: float = 14.0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Place straight, well-separated tube segments in ``shape`` (host side,
    O(n^2) on centerline samples only — no voxel work).

    Returns ``(p0 [n, 3] f32, p1 [n, 3] f32, n_placed)``. Rendering is done
    separately (``render_tubes`` on device) so a 512^3 benchmark phantom
    never exists on the host and never crosses the host->device wire: only
    these ~n*6 floats do. Separation is enforced centerline-to-centerline so
    a correct pipeline must recover exactly ``n_placed`` instances.
    """
    rng = np.random.default_rng(seed)
    shp = np.asarray(shape, np.float64)
    kept = []  # sampled centerline points per accepted segment, [M, 3]
    segs = []
    attempts = 0
    while len(segs) < n_tubes and attempts < n_tubes * 40:
        attempts += 1
        p0 = rng.uniform(radius + 2, shp - radius - 2)
        direction = rng.normal(size=3)
        direction[2] *= 0.3  # mostly in-plane, like the training phantoms
        direction /= np.linalg.norm(direction)
        length = rng.uniform(0.35, 0.7) * float(shp.max())
        p1 = np.clip(p0 + direction * length, radius + 2, shp - radius - 2)
        if np.linalg.norm(p1 - p0) < 8 * radius:
            continue
        n_samp = max(int(np.linalg.norm(p1 - p0) / 8), 2)
        t = np.linspace(0, 1, n_samp)[:, None]
        line = p0 * (1 - t) + p1 * t
        if any(
            np.linalg.norm(line[:, None, :] - prev[None, :, :], axis=-1).min()
            < min_separation
            for prev in kept
        ):
            continue
        kept.append(line)
        segs.append((p0, p1))
    p0s = np.asarray([s[0] for s in segs], np.float32).reshape(-1, 3)
    p1s = np.asarray([s[1] for s in segs], np.float32).reshape(-1, 3)
    return p0s, p1s, len(segs)


def render_tubes(
    shape: Tuple[int, int, int],
    p0,
    p1,
    radius: float = 5.0,
    fg: float = 160.0,
    bg: float = 40.0,
    noise: float = 12.0,
    seed: int = 1,
    device=None,
) -> torch.Tensor:
    """Rasterise tube segments ``p0``/``p1`` ``[n, 3]`` into an f32
    ``[X, Y, Z]`` image on ``device``: fg 160 inside ``radius`` of a
    centreline, bg 40 elsewhere, plus gaussian noise from a
    ``torch.Generator`` seeded with ``seed``, clipped to [0, 255]. The
    noise differs from the JAX package's (another generator); the tubes are
    the same. ``device`` defaults to the first CUDA card (asking for CUDA
    without one raises). Works one X slab at a time to bound temporaries."""
    device = resolve_device(device)
    x, y, z = shape
    segs = torch.stack([torch.as_tensor(np.asarray(p0), dtype=torch.float32),
                        torch.as_tensor(np.asarray(p1), dtype=torch.float32)],
                       1).to(device)  # [n, 2, 3]
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.empty(shape, dtype=torch.float32, device=device)
    yy = torch.arange(y, dtype=torch.float32, device=device).view(1, y, 1)
    zz = torch.arange(z, dtype=torch.float32, device=device).view(1, 1, z)
    slab = max(1, (1 << 24) // (y * z))
    for x0 in range(0, x, slab):
        xx = torch.arange(x0, min(x, x0 + slab), dtype=torch.float32,
                          device=device).view(-1, 1, 1)
        mind = torch.full((xx.shape[0], y, z), float("inf"), device=device)
        for a, b in segs:
            ab = b - a
            ab2 = torch.clamp((ab * ab).sum(), min=1e-6)
            apx, apy, apz = xx - a[0], yy - a[1], zz - a[2]
            apab = apx * ab[0] + apy * ab[1] + apz * ab[2]
            t = torch.clamp(apab / ab2, 0.0, 1.0)
            d2 = apx * apx + apy * apy + apz * apz - 2.0 * t * apab + t * t * ab2
            mind = torch.minimum(mind, d2)
        img[x0:x0 + xx.shape[0]] = torch.where(mind <= radius * radius,
                                               torch.tensor(fg, device=device),
                                               torch.tensor(bg, device=device))
    img += noise * torch.randn(shape, generator=gen, device=device)
    return img.clamp_(0.0, 255.0)


def perfect_prediction(
    labels: np.ndarray,
    skeletons: Dict[int, np.ndarray],
    vector_scale: Tuple[float, float, float] = (60.0, 60.0, 12.0),
    device=None,
) -> np.ndarray:
    """The ideal 5-channel network output for a labelled volume, channels
    last ``[X, Y, Z, 5]`` f32: vectors to the nearest own-instance skeleton
    vertex over ``vector_scale`` (clipped to [-1, 1], 0 off the instances),
    the skeleton channel a disk stamp of radius 2 (flanks 1) at every
    skeleton vertex inside the instances, and the semantic channel the
    foreground. The bake runs on ``device`` (by default the first CUDA
    card, the bake kernel; asking for CUDA without one raises)."""
    from skoots_tpu_torch.ops.skeleton import (bake_skeleton, pack_skeletons,
                                               skeleton_to_mask)
    from skoots_tpu_torch.ops.vec2embed import coordinate_mesh

    device = resolve_device(device)
    packed = pack_skeletons(skeletons, device)
    lab = torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int32)).to(device)
    with torch.no_grad():
        baked = bake_skeleton(lab, packed, average=False)
        diff = (baked - coordinate_mesh(labels.shape, device=device)).cpu().numpy()
        skel_mask = skeleton_to_mask(packed, labels.shape, radius=2,
                                     flank_radius=1).cpu().numpy()
    vec = diff / np.asarray(vector_scale, np.float32)
    vec = np.clip(vec, -1, 1) * (labels > 0)[..., None]
    sem = (labels > 0).astype(np.float32)
    return np.concatenate(
        [vec, skel_mask[..., None] * sem[..., None], sem[..., None]], axis=-1
    ).astype(np.float32)
