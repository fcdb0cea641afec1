"""Synthetic tube phantoms (port of ``skoots_tpu/utils/synthetic.py``).

``make_tubes`` (numpy, copied) makes a small training volume with its
instance masks and skeletons; ``tube_segments`` (numpy, copied) places
straight, well-separated tube segments on the host; ``render_tubes``
rasterises them on the device in torch, so a 512^3 phantom never exists on
the host.
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
) -> Tuple[np.ndarray, np.ndarray, Dict[int, np.ndarray]]:
    """Random smooth tubes: ``(image u8 [X, Y, Z], labels int32 [X, Y, Z],
    skeletons {id: [M, 3] f32})``, the same arrays as the JAX package's
    ``make_tubes`` for the same arguments (tubes may touch)."""
    rng = np.random.default_rng(seed)
    x, y, z = shape
    labels = np.zeros(shape, np.int32)
    skeletons: Dict[int, np.ndarray] = {}

    xx, yy, zz = np.meshgrid(np.arange(x), np.arange(y), np.arange(z), indexing="ij")
    for tid in range(1, n_tubes + 1):
        n_pts = max(x, y) // 2
        t = np.linspace(0, 1, n_pts)
        start = rng.uniform([radius + 1] * 3, [x - radius - 1, y - radius - 1, z - 2])
        end = rng.uniform([radius + 1] * 3, [x - radius - 1, y - radius - 1, z - 2])
        wig = rng.normal(0, 2.0, (3, 3))
        path = (start[None, :] * (1 - t[:, None]) + end[None, :] * t[:, None]
                + np.stack([np.sin(t * np.pi * (k + 1)) for k in range(3)], 1) @ wig)
        path[:, 0] = np.clip(path[:, 0], 1, x - 2)
        path[:, 1] = np.clip(path[:, 1], 1, y - 2)
        path[:, 2] = np.clip(path[:, 2], 1, z - 2)
        skeletons[tid] = path.astype(np.float32)

        # paint the tube: distance to the polyline under z-anisotropy
        d2min = np.full(shape, np.inf)
        for p in path[:: max(1, n_pts // 32)]:
            d2 = (xx - p[0]) ** 2 + (yy - p[1]) ** 2 + ((zz - p[2]) * 3.0) ** 2
            np.minimum(d2min, d2, out=d2min)
        labels[(d2min <= radius**2) & (labels == 0)] = tid

    img = np.full(shape, 40.0)
    img += (labels > 0) * 120.0
    img += np.random.default_rng(seed + 1).normal(0, 12.0, shape)
    return np.clip(img, 0, 255).astype(np.uint8), labels, skeletons


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
