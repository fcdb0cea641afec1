"""Inputs for the propagate kernel's tests (no JAX: the card's tests in
``test_torch_infer_cuda.py`` use them too)."""

import numpy as np
import torch

from skoots_tpu_torch.kernels.propagate import QMAX, propagate_ref

# 1, a few, QMAX, one more, and a remainder after two full launches
PASSES = sorted({1, 3, QMAX, QMAX + 1, 2 * QMAX + 3})


def corner_tube_case(shape, tile, seed, background_labels):
    """(labels int32, fg uint8): a blob field in one corner box (so other
    tiles have no foreground), a two-voxel tube from the origin along the
    diagonal of ``tile`` ((QMAX, TX, TY, VZ)), through the tiles' corners,
    and one straight line along each axis (a 6-connected label crosses a
    tile's face only along them). Labels: voxel index + 1 on the foreground
    (the CC's start), and with ``background_labels`` random labels up to
    2^30 at the corner box's background (they enter the foreground in the
    first pass and travel out along the tube)."""
    qmax, tx, ty, vz = tile
    diag = np.array([tx, ty, 32 * vz - 2 * qmax], np.float64)
    rng = np.random.default_rng(seed)
    fg = np.zeros(shape, bool)
    box = tuple(slice(0, max(1, s // 3)) for s in shape)
    fg[box] = rng.random(fg[box].shape) < 0.3
    reach = float(np.max(np.asarray(shape) / diag)) + 1
    t = np.linspace(0.0, reach, int(reach * diag.max() * 2) + 2)[:, None]
    pts = np.round(t * diag).astype(np.int64)
    pts = pts[(pts < np.asarray(shape)).all(axis=1)]
    for corner in np.ndindex(2, 2, 2):  # 2^3 cubes: 6-connected too
        p = np.minimum(pts + np.asarray(corner), np.asarray(shape) - 1)
        fg[p[:, 0], p[:, 1], p[:, 2]] = True
    xs, ys, zs = shape
    fg[:, ys // 2, zs // 2] = fg[xs // 2, :, zs - 1] = fg[xs - 1, ys - 1, :] = True
    idx = np.arange(1, fg.size + 1, dtype=np.int32).reshape(shape)
    lab = np.where(fg, idx, 0).astype(np.int32)
    if background_labels:
        big = np.zeros(shape, np.int32)
        big[box] = rng.integers(1, 2**30, big[box].shape)
        lab = np.where(fg, lab, big).astype(np.int32)
    return torch.from_numpy(lab), torch.from_numpy(fg.astype(np.uint8))


def plain(labels, fg, passes, conn):
    """``propagate_ref`` applied ``passes`` times."""
    for _ in range(passes):
        labels = propagate_ref(labels, fg, conn)
    return labels
