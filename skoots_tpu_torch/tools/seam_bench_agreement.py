"""Instance agreement between two tile geometries on one 512^3 tube phantom
(port of ``tools/seam_bench_agreement.py``, names kept).

    python -m skoots_tpu_torch.tools.seam_bench_agreement
        [--ckpt runs/bench_ckpt.skoots | DIR] [--shape 512,512,512] [--n-tubes 48]
        [--out runs/seam_bench_agreement_torch.json] [--device cuda]

Segments the same phantom (:func:`make_tubes_big`, seed 7) with a trained
checkpoint under

  A. the overlap geometry        crop 192x192x96, overlap (8, 8, 4)
  B. the zero-overlap bench grid crop 256x256x96, overlap (0, 0, 0)

(assignment on 256x256x96 tiles without overlap, N = 10, the engine's
``auto``), scores each against the generator's ground truth and B against A
(``accuracy_campaign.score``: F1 at IoU 0.5 and mean IoU) and writes the
JSON (the JAX tool's keys, plus the device, the card's name and power
limit). The phantom goes through a tif under ``runs/seam_bench_torch/``, as
the JAX tool's goes through ``runs/seam_bench/``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def _y_window(p0, p1, x0: int, x1: int, radius: float, lo: int, hi: int):
    """The y rows ``[lo', hi')`` of the bounding box that can hold a voxel
    of x-planes ``[x0, x1)`` within ``radius`` of the segment ``p0``-``p1``
    (with 2 voxels to spare): such a voxel's nearest segment point lies
    within ``radius`` of it in x and in y."""
    d = p1 - p0
    if abs(d[0]) < 1e-9:
        ts = (0.0, 1.0)
    else:
        ts = np.clip(((x0 - radius - 2 - p0[0]) / d[0],
                      (x1 + radius + 1 - p0[0]) / d[0]), 0.0, 1.0)
    ys = p0[1] + d[1] * np.asarray(ts)
    return (max(lo, int(np.floor(ys.min() - radius - 2))),
            min(hi, int(np.ceil(ys.max() + radius + 2)) + 1))


def _tube_labels(labels: np.ndarray, line: np.ndarray, p0, p1, radius: float,
                 tid: int, shape: np.ndarray, planes: int = 16) -> None:
    """Write ``tid`` into the unlabelled voxels of ``labels`` within
    ``radius`` of the segment ``p0``-``p1``, inside the tube's padded
    bounding box only, ``planes`` x-planes of it at a time and of those
    only the y rows :func:`_y_window` leaves (each voxel's float32
    arithmetic is the JAX tool's whatever the split: numpy's matmul loops
    over the leading axes and reduces along z)."""
    lo = np.maximum(np.floor(line.min(0) - radius - 1).astype(int), 0)
    hi = np.minimum(np.ceil(line.max(0) + radius + 2).astype(int), shape)
    ab = (p1 - p0).astype(np.float32)
    for x0 in range(lo[0], hi[0], planes):
        x1 = min(x0 + planes, hi[0])
        y0, y1 = _y_window(p0, p1, x0, x1, radius, lo[1], hi[1])
        if y0 >= y1:
            continue
        gx, gy, gz = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1),
                                 np.arange(lo[2], hi[2]), indexing="ij")
        pts = np.stack([gx, gy, gz], -1).astype(np.float32)  # [bx, by, bz, 3]
        # distance from each bbox voxel to the segment p0-p1
        ap = pts - p0.astype(np.float32)
        tt = np.clip((ap @ ab) / float(ab @ ab), 0.0, 1.0)
        closest = p0.astype(np.float32) + tt[..., None] * ab
        dist = np.linalg.norm(pts - closest, axis=-1)
        blk = labels[x0:x1, y0:y1, lo[2]:hi[2]]
        sel = (dist <= radius) & (blk == 0)
        blk[sel] = tid


def make_tubes_big(shape, n_tubes: int, radius: float = 5.0, seed: int = 7,
                   min_separation: float = 14.0, labels: np.ndarray | None = None):
    """Straight-ish random tubes rasterized only inside their bounding
    boxes: O(sum of tube bbox volumes), not O(volume * path points).

    Returns (image u8, labels int32, tubes placed), voxel for voxel the JAX
    tool's for the same arguments. Separation is enforced by rejecting
    candidate segments whose centerline comes within ``min_separation`` of
    an accepted one (coarse 8-voxel sampling of both polylines).
    ``labels``: a zeroed int32 array of ``shape`` (e.g. a disk memmap) to
    rasterize into instead of a new one; the image is built from it x-slab
    by x-slab, so besides the labels the call holds the int16 noise field
    and the image."""
    rng = np.random.default_rng(seed)
    shape = np.asarray(shape)
    if labels is None:
        labels = np.zeros(tuple(shape), np.int32)
    kept = []  # sampled centerline points per tube, [M,3]
    tid = 0
    attempts = 0
    while tid < n_tubes and attempts < n_tubes * 40:
        attempts += 1
        p0 = rng.uniform(radius + 2, shape - radius - 2)
        direction = rng.normal(size=3)
        direction[2] *= 0.3  # mostly in-plane, like the training phantoms
        direction /= np.linalg.norm(direction)
        length = rng.uniform(0.35, 0.7) * float(shape.max())
        p1 = p0 + direction * length
        p1 = np.clip(p1, radius + 2, shape - radius - 2)
        if np.linalg.norm(p1 - p0) < 8 * radius:
            continue
        n_samp = max(int(np.linalg.norm(p1 - p0) / 8), 2)
        t = np.linspace(0, 1, n_samp)[:, None]
        line = p0 * (1 - t) + p1 * t
        ok = True
        for prev in kept:
            d = np.linalg.norm(line[:, None, :] - prev[None, :, :], axis=-1)
            if d.min() < min_separation:
                ok = False
                break
        if not ok:
            continue
        tid += 1
        kept.append(line)
        _tube_labels(labels, line, p0, p1, radius, tid, shape)
    noise = rng.integers(-20, 20, labels.shape, dtype=np.int16)
    img = np.empty(labels.shape, np.uint8)
    for x0 in range(0, labels.shape[0], 64):
        sl = slice(x0, x0 + 64)
        blk = np.where(labels[sl] > 0, 200, 30).astype(np.int16) + noise[sl]
        img[sl] = np.clip(blk, 0, 255).astype(np.uint8)
    return img, labels, tid


GEOMETRIES = {
    "A_overlap_r2": dict(crop_size=(192, 192, 96), overlap=(8, 8, 4)),
    "B_zero_overlap_r3": dict(crop_size=(256, 256, 96), overlap=(0, 0, 0)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.seam_bench_agreement",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", default="runs/bench_ckpt.skoots")
    ap.add_argument("--shape", default="512,512,512")
    ap.add_argument("--n-tubes", type=int, default=48)
    ap.add_argument("--out", default="runs/seam_bench_agreement_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to segment and score on (default cuda)")
    args = ap.parse_args(argv)

    from skoots_tpu_torch.infer import run_inference
    from skoots_tpu_torch.tools.accuracy_campaign import _device_record, score
    from skoots_tpu_torch.utils.device import resolve_device
    from skoots_tpu_torch.utils.io import imsave

    device = resolve_device(args.device)
    ckpt = args.ckpt
    if os.path.isdir(ckpt):  # a training run's models directory: its newest
        cands = sorted(glob.glob(os.path.join(ckpt, "*.skoots")))
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {ckpt}")
        ckpt = cands[-1]
    shape = tuple(int(v) for v in args.shape.split(","))
    work = os.path.join(os.path.dirname(args.out) or ".", "seam_bench_torch")
    os.makedirs(work, exist_ok=True)
    vol_path = os.path.join(work, "vol.tif")

    t0 = time.time()
    img, gt, n_placed = make_tubes_big(shape, args.n_tubes)
    imsave(vol_path, img)
    synth_s = time.time() - t0
    print(f"phantom: {n_placed} tubes in {synth_s:.0f}s", flush=True)

    masks = {}
    rows = {}
    for name, g in GEOMETRIES.items():
        t0 = time.time()
        m = np.asarray(run_inference(
            vol_path, ckpt, assign_crop_size=(256, 256, 96),
            assign_overlap=(0, 0, 0), embed_iterations=10, device=device, **g,
        )).squeeze()
        rows[name] = {**g, "wall_s": round(time.time() - t0, 1),
                      "vs_gt": score(gt, m, device)}
        masks[name] = m
        print(json.dumps({name: rows[name]}, default=str), flush=True)

    agree = score(masks["A_overlap_r2"], masks["B_zero_overlap_r3"], device)
    out = {"shape": list(shape), "n_tubes": n_placed, "checkpoint": ckpt,
           "geometries": rows, "agreement_B_vs_A": agree, "synth_s": round(synth_s, 1),
           **_device_record(device)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
