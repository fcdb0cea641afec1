"""Training traffic: labelled tube volumes, drawn from the seed.

A mix file (``traffic/<mix>.json``, ``"kind": "tube_records"``) gives the
volume shape, the number of volumes, the tubes a volume, their radius and
separation, the intensities, and the training step's ``batch`` and
``epoch``. Volume ``i`` of a run with seed ``s`` places straight tubes
(``tube_blocks.tube_segments`` seeded from ``(s, i)``), labels each voxel
within ``radius`` of a centreline with that tube's id (1..n) on the card,
renders the image as ``tube_blocks.render_tubes`` does, and takes the
skeleton of each tube from its own axis: points one voxel apart from end to
end. No host thinning. Returned on the host, as the training CLI holds its
records: image f32, labels int32, ``{id: [M, 3] f32}``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic.tube_blocks import (_boxes, block_seed, render_tubes, segment_d2,
                                           tube_segments)


def label_tubes(shape, p0, p1, radius: float, device) -> torch.Tensor:
    """int32 ``[X, Y, Z]``: 1 + the index of the nearest segment within
    ``radius`` of the voxel (the first on ties), 0 elsewhere; each segment
    measured only inside its own box."""
    segs = torch.stack([torch.as_tensor(p0), torch.as_tensor(p1)], 1).float().to(device)
    out = torch.zeros(shape, dtype=torch.int32, device=device)
    best = torch.full(shape, float(radius) ** 2, device=device)
    for k, (lo, hi) in enumerate(_boxes(shape, p0, p1, radius)):
        box = tuple(slice(a, b) for a, b in zip(lo, hi))
        d2 = segment_d2(segs[k], lo, hi, device)
        closer = (d2 < best[box]) | ((d2 <= best[box]) & (out[box] == 0))
        best[box] = torch.where(closer, d2, best[box])
        out[box] = torch.where(closer, k + 1, out[box])
    return out


def axis_points(p0, p1) -> np.ndarray:
    n = max(int(np.ceil(np.linalg.norm(p1 - p0))) + 1, 2)
    t = np.linspace(0.0, 1.0, n, dtype=np.float64)[:, None]
    return (p0 * (1 - t) + p1 * t).astype(np.float32)


def make(mix: dict, seed: int, device) -> list:
    """The mix's volumes: dicts of ``image``, ``masks``, ``skeletons``."""
    shape = tuple(mix["shape"])
    r = float(mix["radius"])
    recs = []
    for i in range(int(mix["volumes"])):
        s = block_seed(seed, 1000 + i)
        p0, p1, n = tube_segments(shape, int(mix["tubes"]), r, s, float(mix["min_separation"]))
        img = render_tubes(shape, p0, p1, r, float(mix["fg"]), float(mix["bg"]),
                           float(mix["noise"]), s, device).round_()
        masks = label_tubes(shape, p0, p1, r, device)
        skeletons = {k + 1: axis_points(p0[k].astype(np.float64), p1[k].astype(np.float64))
                     for k in range(n)}
        recs.append({"image": img.cpu().numpy(), "masks": masks.cpu().numpy(),
                     "skeletons": skeletons})
        del img, masks
    return recs
