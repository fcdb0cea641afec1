"""The training path's depthwise weight gradient (``csrc/dwconv_wgrad.cu``)
and skeleton bake (``csrc/bake.cu``) on the card: checked and timed.

    python -m skoots_tpu_torch.tools.bench_train_kernels [--out FILE] [--repeats N]

At ``chip_smoke.py``'s training shapes (the bench training crop 96x96x32
and its two coarser levels, batch 1), the weight gradient at the stem
(1 -> 32), C = 32, 64 and 128 in bf16, a ragged batch of 2 (X, Y, Z no
multiple of any tile) for the depthwise and the stem kernels, and C = 64
in f32; each held to 1e-3 * max|plain| (f32 sums of the same exact
products in another order) and to itself on a second run (fixed-order
sums). The bake at the dense crop with 8 box instances and P = 256 and
4,096 points, the sparse loss's all-foreground case (256 points, 192
valid), equidistant duplicate points (the first minimal point decides)
and a crop of 40 instances in every tile (the over-cap scan); each held
to the plain version bit for bit. Times are medians of ``--repeats``
CUDA-event runs of the wrapper, its plain version and, for the weight
gradient, cuDNN's ``conv3d_weight``, and the wrapper's kernels' own device
time under ``torch.profiler`` (``device_ms``); bounds from the bytes moved
(at 3.35 TB/s) and the operations (bf16 products at 989 TFLOP/s on the
tensor cores, other operations at 67 TFLOP/s FP32). Prints a line a case,
then one JSON line of the rows; exits 1 if a check fails.

The cases and the bound are ``chip_smoke.py``'s too (it imports them):
``wgrad_inputs`` and ``bake_cases`` draw the training path's cases from the
caller's generator in the order ``chip_smoke.py`` has drawn them since it
first checked these kernels, and the added cases (the ragged batches, f32,
duplicates, 40 ids a tile) from a second generator, so the first keep
their inputs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad, dwconv3d_wgrad_ref
from skoots_tpu_torch.tools import median_ms

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# FP32 FLOP/s outside the tensor cores (an FMA counts 2, so other
# instructions issue at half of it), dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
CROP = (96, 96, 32)
# (name, [B, X, Y, Z], input channels, channels, dtype): the training
# path's stem and three block levels, then the added cases
WGRAD_CASES = (
    ("stem", (1, 96, 96, 32), 1, 32, "bf16"),
    ("C=32", (1, 96, 96, 32), 32, 32, "bf16"),
    ("C=64", (1, 48, 48, 16), 64, 64, "bf16"),
    ("C=128", (1, 24, 24, 8), 128, 128, "bf16"),
    ("ragged C=32 B=2", (2, 41, 37, 19), 32, 32, "bf16"),
    ("ragged stem B=2", (2, 41, 37, 19), 1, 32, "bf16"),
    ("f32 C=64", (1, 48, 48, 16), 64, 64, "f32"),
)
WGRAD_PATH_CASES = 4  # the first four: drawn from the caller's generator
ANISO = (1.0, 1.0, 3.0)


def bound(moved: float, fp32_flops: float = 0.0, tensor_flops: float = 0.0):
    """(least ms, what bounds it): the largest of the bytes moved over the
    HBM rate and the operations over their type's peak (FP32 outside the
    tensor cores; bf16 products on the tensor cores). The two pipes run at
    once, so operations of both types cost the longer of their times."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(fp32_flops / FP32_FLOP_PER_S, tensor_flops / BF16_TENSOR_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def wgrad_bound(x, g, out):
    """The weight gradient's least time: k^3 products a cotangent value (k
    from ``out`` ``[k, k, k, C]``), on the tensor cores at bf16 (exact in
    f32), on the FP32 pipe at f32."""
    products = 2.0 * out.shape[0] ** 3 * g.numel()
    ops = ({"tensor_flops": products} if x.dtype == torch.bfloat16
           else {"fp32_flops": products})
    return bound(nbytes(x, g, out), **ops)


def bake_bound(masks, pts, ids, baked, dist):
    """The bake's least time: 11 FP32 operations for every foreground voxel
    and every point of its own instance (the work this data needs)."""
    n_id = int(max(int(masks.max()), int(ids.max()))) + 1
    per_id = torch.bincount(ids[ids > 0].long(), minlength=n_id)
    pairs = float(torch.where(masks > 0, per_id[masks.long().clamp_min(0)], 0).sum())
    return bound(nbytes(masks, pts, ids, baked, dist), fp32_flops=11.0 * pairs)


def wgrad_inputs(rng, extra_rng, device="cuda", cases=WGRAD_CASES):
    """Yield ``(name, x, g)`` a case: x standard normal, g 1e-3 of it, in
    the case's dtype on ``device``; the first ``WGRAD_PATH_CASES`` from
    ``rng``, the rest from ``extra_rng``."""
    for i, (name, shape, cin, c, dt) in enumerate(cases):
        r = rng if i < WGRAD_PATH_CASES else extra_rng
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.from_numpy(r.standard_normal((*shape, cin)).astype(np.float32))
        g = torch.from_numpy((r.standard_normal((*shape, c)) * 1e-3).astype(np.float32))
        yield name, x.to(device).to(dtype), g.to(device).to(dtype)


def device_ms(fn, calls: int = 5) -> float:
    """Device time of one call: the CUDA kernels' own time under
    ``torch.profiler``, summed over ``calls`` calls and divided by them
    (what the CUDA events add on top of it is the host's launch path)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / calls


def wgrad_rows(rng, extra_rng, repeats: int) -> list:
    rows = []
    for name, x, g in wgrad_inputs(rng, extra_rng):
        cin, c = x.shape[-1], g.shape[-1]
        dt = "bf16" if x.dtype == torch.bfloat16 else "f32"
        got = dwconv3d_wgrad(x, g, 7)
        again = dwconv3d_wgrad(x, g, 7)
        ref = dwconv3d_wgrad_ref(x, g, 7)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        xv, gv = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        groups = 1 if cin == 1 else c
        least = wgrad_bound(x, g, got)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            library = median_ms(lambda: torch.nn.grad.conv3d_weight(
                xv, (c, 1, 7, 7, 7), gv, padding=3, groups=groups), repeats)
        row = {"kernel": "dwconv3d_wgrad", "case": name, "shape": [*x.shape, c],
               "dtype": dt, "err_of_max": err, "tol": 1e-3,
               "same_run_to_run": bool(torch.equal(got, again)),
               "ms": median_ms(lambda: dwconv3d_wgrad(x, g, 7), repeats),
               "device_ms": device_ms(lambda: dwconv3d_wgrad(x, g, 7)),
               "plain_ms": median_ms(lambda: dwconv3d_wgrad_ref(x, g, 7), repeats),
               "library_ms": library, "bound_ms": least[0], "bound_by": least[1]}
        row["ok"] = row["err_of_max"] <= row["tol"] and row["same_run_to_run"]
        rows.append(row)
        print(f"wgrad {name} {dt}: err {err:.3g} of max|plain| (tol 1e-3), "
              f"run-to-run equal {row['same_run_to_run']}, {row['ms']:.4f} ms "
              f"(device {row['device_ms']:.4f}), "
              f"plain {row['plain_ms']:.3f}, cuDNN {library:.3f}, bound "
              f"{least[0]:.4f} ({least[1]}) {'ok' if row['ok'] else 'FAIL'}", flush=True)
        del x, g, got, again, ref, xv, gv
    return rows


def box_masks(rng, shape=CROP, n=8) -> tuple:
    """``n`` box instances (ids 1..n, later ones on top) and their boxes."""
    masks = torch.zeros(shape, dtype=torch.int32)
    boxes = []
    for i in range(1, n + 1):
        lo = rng.integers(0, np.asarray(shape) // 2)
        hi = lo + rng.integers(4, np.asarray(shape) // 2)
        masks[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = i
        boxes.append((lo, hi))
    return masks, boxes


def points_in_boxes(rng, boxes, p: int, padding: int) -> tuple:
    """``p`` points, each inside the box of its random id; the last
    ``padding`` ids 0."""
    ids = rng.integers(1, len(boxes) + 1, p).astype(np.int32)
    if padding:
        ids[-padding:] = 0
    lo = np.stack([boxes[i - 1][0] for i in np.maximum(ids, 1)])
    hi = np.stack([boxes[i - 1][1] for i in np.maximum(ids, 1)])
    return (lo + rng.random((p, 3)) * (hi - lo)).astype(np.float32), ids


def bake_cases(rng, extra_rng, shape=CROP, sparse_points=256) -> list:
    """(name, masks, points, ids) of every bake case, on the CPU: from
    ``rng`` 8 box instances with P = 256 and 4,096 points inside them (a
    sixteenth padding) and the sparse loss's case (all foreground,
    ``sparse_points`` points, a quarter padding); from ``extra_rng``
    equidistant duplicates and 40 ids in every tile (the over-cap scan)."""
    masks, boxes = box_masks(rng, shape)
    cases = []
    for p in (256, 4096):
        pts, ids = points_in_boxes(rng, boxes, p, p // 16)
        cases.append((f"dense P={p}", masks, pts, ids))
    p = sparse_points
    ones = torch.ones(shape, dtype=torch.int32)
    cases.append((f"sparse all-fg P={p}", ones,
                  (rng.random((p, 3)) * np.asarray(shape)).astype(np.float32),
                  (np.arange(p) < p - p // 4).astype(np.int32)))
    # equidistant duplicates: 128 integer points, each again two voxels
    # further in x and then repeated, so many voxels see two or three
    # points at one d2 (the first minimal decides)
    pts, ids = points_in_boxes(extra_rng, boxes, 128, 0)
    pts = np.round(pts)
    mirror = pts.copy()
    mirror[:, 0] += 2.0
    pts2 = np.concatenate([pts, mirror, pts]).astype(np.float32)
    ids2 = np.concatenate([ids, ids, ids]).astype(np.int32)
    cases.append(("duplicates P=384", masks, pts2, ids2))
    many = torch.from_numpy(extra_rng.integers(1, 41, shape).astype(np.int32))
    many[:, :, : shape[2] // 4] = 0
    pts3 = (extra_rng.random((1024, 3)) * np.asarray(shape)).astype(np.float32)
    cases.append(("40 ids a tile P=1024", many, pts3,
                  extra_rng.integers(0, 41, 1024).astype(np.int32)))
    return cases


def bake_rows(rng, extra_rng, repeats: int) -> list:
    rows = []
    for name, masks, pts, ids in bake_cases(rng, extra_rng):
        m = masks.cuda()
        pts_t, ids_t = torch.from_numpy(pts).cuda(), torch.from_numpy(ids).cuda()
        got = bake_skeleton_kernel(m, pts_t, ids_t, ANISO)
        ref = bake_skeleton_ref(m, pts_t, ids_t, ANISO)
        torch.cuda.synchronize()
        diff = int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
        least = bake_bound(m, pts_t, ids_t, *got)
        row = {"kernel": "bake_skeleton", "case": name, "shape": [*m.shape, len(ids)],
               "values_differing": diff, "ok": diff == 0,
               "ms": median_ms(lambda: bake_skeleton_kernel(m, pts_t, ids_t, ANISO), repeats),
               "device_ms": device_ms(lambda: bake_skeleton_kernel(m, pts_t, ids_t, ANISO)),
               "plain_ms": median_ms(lambda: bake_skeleton_ref(m, pts_t, ids_t, ANISO),
                                     repeats),
               "library_ms": None, "bound_ms": least[0], "bound_by": least[1]}
        rows.append(row)
        print(f"bake {name}: {diff} values differing, {row['ms']:.4f} ms (device "
              f"{row['device_ms']:.4f}), plain "
              f"{row['plain_ms']:.3f}, bound {least[0]:.4f} ({least[1]}) "
              f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
    return rows


def measure(repeats: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_train_kernels measures a CUDA card; none is available")
    rng, extra = np.random.default_rng(0), np.random.default_rng(1)
    rows = wgrad_rows(rng, extra, repeats) + bake_rows(rng, extra, repeats)
    return {"device": torch.cuda.get_device_name(0), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    result = measure(repeats=args.repeats)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if all(r["ok"] for r in result["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
