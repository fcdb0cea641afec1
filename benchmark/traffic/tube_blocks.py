"""Segmentation traffic: distinct blocks of straight tubes, drawn from the seed.

A mix file (``traffic/<mix>.json``, ``"kind": "tube_blocks"``) gives the block
shape, the number of distinct blocks, the tubes a block, their radius and
centreline separation, and the image's intensities. Block ``i`` of a run with
seed ``s`` places its tubes with ``numpy.random.default_rng`` seeded from
``(s, i)`` and renders them on the card, each tube only inside its own box;
the blocks are then held on the host as uint8 arrays, as the CLI holds a
stack it has read.

:func:`tube_segments` gives exactly the segments of the program's
``utils/synthetic.py::tube_segments`` for the same seed (the same draws in the
same order, the same float64 distance test), but finds the earlier centreline
samples near a candidate through a grid of cells one separation wide, so 400
tubes in 512^3 take well under a second instead of minutes.
"""

from __future__ import annotations

import numpy as np
import torch


def tube_segments(shape, n_tubes: int, radius: float = 5.0, seed: int = 7,
                  min_separation: float = 14.0):
    """``(p0 [n, 3] f32, p1 [n, 3] f32, n_placed)``: straight segments, each
    centreline sample at least ``min_separation`` from every earlier
    segment's samples; at most ``40 * n_tubes`` attempts."""
    rng = np.random.default_rng(seed)
    shp = np.asarray(shape, np.float64)
    cell = float(min_separation)
    span = int(np.ceil(shp.max() / cell)) + 3
    offsets = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dz in (-1, 0, 1)], np.int64)
    grid: dict = {}  # packed cell index -> earlier samples [k, 3]
    occupied = np.zeros(span ** 3, bool)
    mult = np.array([span * span, span, 1], np.int64)
    segs = []
    attempts = 0
    while len(segs) < n_tubes and attempts < n_tubes * 40:
        attempts += 1
        p0 = rng.uniform(radius + 2, shp - radius - 2)
        direction = rng.normal(size=3)
        direction[2] *= 0.3
        direction /= np.linalg.norm(direction)
        length = rng.uniform(0.35, 0.7) * float(shp.max())
        p1 = np.clip(p0 + direction * length, radius + 2, shp - radius - 2)
        if np.linalg.norm(p1 - p0) < 8 * radius:
            continue
        n_samp = max(int(np.linalg.norm(p1 - p0) / 8), 2)
        t = np.linspace(0, 1, n_samp)[:, None]
        line = p0 * (1 - t) + p1 * t
        cells = np.floor(line / cell).astype(np.int64) + 1
        keys = cells @ mult
        near = (cells[:, None, :] + offsets[None]) @ mult
        hit = near[occupied[near]]
        if hit.size:
            prev = np.concatenate([grid[k] for k in np.unique(hit).tolist()])
            if np.linalg.norm(line[:, None, :] - prev[None, :, :],
                              axis=-1).min() < min_separation:
                continue
        for k, p in zip(keys.tolist(), line):
            grid[k] = np.vstack([grid[k], p[None]]) if k in grid else p[None]
            occupied[k] = True
        segs.append((p0, p1))
    p0s = np.asarray([s[0] for s in segs], np.float32).reshape(-1, 3)
    p1s = np.asarray([s[1] for s in segs], np.float32).reshape(-1, 3)
    return p0s, p1s, len(segs)


def _boxes(shape, p0, p1, radius: float):
    """Per segment, the voxel box that holds every voxel within ``radius``
    of it: ``[(lo, hi)]`` of ints, clamped to the volume."""
    a, b = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    lo = np.floor(np.minimum(a, b) - radius - 1).astype(np.int64).clip(0)
    hi = np.ceil(np.maximum(a, b) + radius + 2).astype(np.int64)
    hi = np.minimum(hi, np.asarray(shape, np.int64))
    return list(zip(lo.tolist(), hi.tolist()))


def segment_d2(seg, lo, hi, device):
    """Squared distance of every voxel of the box ``[lo, hi)`` to the
    segment ``seg`` ``[2, 3]`` (the program's formula, f32)."""
    ax = [torch.arange(lo[i], hi[i], dtype=torch.float32, device=device) for i in range(3)]
    xx, yy, zz = ax[0].view(-1, 1, 1), ax[1].view(1, -1, 1), ax[2].view(1, 1, -1)
    a, ab = seg[0], seg[1] - seg[0]
    ab2 = torch.clamp((ab * ab).sum(), min=1e-6)
    apx, apy, apz = xx - a[0], yy - a[1], zz - a[2]
    apab = apx * ab[0] + apy * ab[1] + apz * ab[2]
    t = torch.clamp(apab / ab2, 0.0, 1.0)
    return apx * apx + apy * apy + apz * apz - 2.0 * t * apab + t * t * ab2


def render_tubes(shape, p0, p1, radius: float, fg: float, bg: float,
                 noise: float, seed: int, device) -> torch.Tensor:
    """f32 ``[X, Y, Z]`` on ``device``: ``fg`` within ``radius`` of a
    centreline, ``bg`` elsewhere, plus gaussian noise from a generator on
    ``device`` seeded with ``seed``, clipped to [0, 255]. Each segment is
    measured only inside its own box (:func:`_boxes`); the distances are the
    program's ``render_tubes``', so the image is too."""
    segs = torch.stack([torch.as_tensor(np.asarray(p0), dtype=torch.float32),
                        torch.as_tensor(np.asarray(p1), dtype=torch.float32)],
                       1).to(device)
    inside = torch.zeros(shape, dtype=torch.bool, device=device)
    for k, (lo, hi) in enumerate(_boxes(shape, p0, p1, radius)):
        box = tuple(slice(a, b) for a, b in zip(lo, hi))
        inside[box] |= segment_d2(segs[k], lo, hi, device) <= radius * radius
    img = torch.where(inside, torch.tensor(fg, device=device), torch.tensor(bg, device=device))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    img += noise * torch.randn(shape, generator=gen, device=device)
    return img.clamp_(0.0, 255.0)


def block_seed(seed: int, index: int) -> int:
    """The placement seed of block ``index`` of a run with ``seed``."""
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(index)])
               .generate_state(1, np.uint32)[0])


def make(mix: dict, seed: int, device) -> list:
    """The mix's distinct blocks: a list of dicts with ``volume`` (uint8
    ``[X, Y, Z]`` numpy, on the host), ``n_tubes`` (placed) and the
    segments."""
    shape = tuple(mix["shape"])
    blocks = []
    for i in range(int(mix["blocks"])):
        s = block_seed(seed, i)
        p0, p1, n = tube_segments(shape, int(mix["tubes"]), float(mix["radius"]),
                                  s, float(mix["min_separation"]))
        img = render_tubes(shape, p0, p1, float(mix["radius"]), float(mix["fg"]),
                           float(mix["bg"]), float(mix["noise"]), s, device)
        vol = img.round_().to(torch.uint8).cpu().numpy()
        del img
        blocks.append({"volume": vol, "n_tubes": n, "p0": p0, "p1": p1})
    return blocks
