"""Drive the PyTorch/CUDA port (``skoots_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc``; exits non-zero (printing no result) without
them. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skoots_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and counts the tensor-core
   instructions (HMMA / HGMMA) of every instantiation of the bf16 block
   tail, depthwise conv, stem, LN head and the depthwise conv's and stem's
   weight gradients in the library's SASS (``cuobjdump -sass``; none
   fails);
3. compares every kernel with its plain PyTorch version on the card, at the
   shapes the main paths give it, on seeded random inputs (propagate also
   on the main path's sparse mask: one 192-pass CC round on the 512^3
   phantom's dilated skeleton), and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call, with CUDA events (median of several runs); the
   depthwise conv, the block tail and the LN head also at the host
   engine's and the training path's shapes, ragged shapes, k = 3 and f32,
   the block tail and the LN head beside their plain cuBLAS compositions;
   checks the depthwise conv's bf16
   input gradient against its plain composition, and that the block
   tail's and LN head's autograd backward is exactly the autograd of their
   plain compositions;
4. the two microbenchmarks (``skoots_tpu_torch.tools.bench_fma_rate`` and
   ``bench_loadfma``), each checked against its plain version, with their
   rates;
5. host-streaming engine: ``infer.engine.run_inference`` at its defaults
   (``auto`` -> host at 256^3) on a seeded 256^3 tube phantom saved as
   ``.npy``, with the bench checkpoint ``runs/bench_ckpt.skoots`` at full
   width, every launch count set to 0 just before and read just after:
   instance count, stage split, launches against the forwards and CC rounds
   the engine ran (the plain propagation may not run); then the same with
   ``use_cached_data`` (the mask must be equal) and with ``out_of_core``
   (recompute + memmaps); then on a 128x128x32 block on the card and on the
   CPU (every kernel's plain version), compared instance by instance;
6. whole-volume path: ``infer.device_pipeline.make_chunked_pipeline`` on the
   bench checkpoint over the seeded 512^3 tube phantom rendered on the card,
   with ``bench.py``'s knobs -- launch counts set to 0 just before and read
   just after (propagate: ``len(launch_plan(192))`` a CC round, the plain
   propagation may not run); prints the phase split, the instance count
   against the number of placed tubes, the CC rounds, the launch counts and
   peak device memory;
7. runs the same pipeline on a 128x128x64 block of the phantom on the card
   and on the CPU and compares the instances;
8. device-thrifty path: ``infer.device_pipeline.make_thrifty_pipeline`` on
   the same phantom as a uint8 host array, with the same knobs (the assign
   phase runs the forward again on 256x256x64 tiles), launch counts set to
   0 just before and read just after (each forward kernel per forward of
   the pipeline's tile plan, propagate per CC round), the mask 16-bit and
   numbered 1..N, the instance count, the phase split and peak device
   memory (held against ``estimated_device_bytes`` with one forward tile's
   peak; the CC and compaction alone against its 13 B a voxel), a warm
   rerun and the chunked pipeline again; then ``skoots-validate``'s
   metrics on the card (thrifty mask against the chunked one: F1@0.5 >=
   0.95) and their IoU, Dice and clDice tables against the CPU's;
9. the sparse-checkpoint probe (``infer.engine._probe_semantic_threshold``)
   on the phantom at ``run_inference``'s 512^3 probe geometry, launch counts
   set to 0 just before and read just after, and its threshold on the card
   against the CPU's plain versions on a block three tubes cross;
10. ``infer.engine.run_inference`` on the uint8 phantom (``.npy``) with
   ``engine_impl="device-thrifty"``, then with ``auto`` while a ballast
   tensor leaves free only memory halfway between the thrifty and chunked
   estimates (``auto`` must take the thrifty pipeline and finish): launch
   counts, the phases JSON, the instance count;
11. one f32 train step of the full-width model on a 32x32x16 batch, on the
   card and on the CPU from the same weights: loss and every gradient;
12. training path (``skoots-train`` at the bench checkpoint's training cfg:
   bf16, crop 96x96x32, batch 1, on seeded synthetic tube volumes): 8 steps
   on one augmented batch (the loss must fall; the step time split into
   augment, forward + loss, backward and optimizer, and peak memory), then
   ``train.engine.train`` for 2 epochs of 8 steps through the whole
   augmentation with the launch counts set to 0 before and read after, and
   the saved checkpoint loaded back and run;
13. ground-truth skeletons: ``train.generate_skeletons.calculate_skeletons``
    with Lee thinning (host C++) on the training phase's two volumes, every
    instance with a point and >= 95% of the points in their own instance;
14. sparse training (``experimental.sparse_engine``) at the same cfg with
    ``IS_SPARSE``, on those volumes and skeletons as in-memory
    ``SparseRecord``s: 8 steps on one batch (the step split), then
    ``train_sparse`` for 2 epochs of 8 steps, the launch counts set to 0
    before and read after (exact: per step and per forward of the threshold
    calibrator), every loss finite, the ``*_sparse.skoots`` checkpoint with
    a calibrated threshold, reloaded; then ``run_inference`` with it on a
    128x128x64 block of the 256^3 phantom, printing which semantic gate won;
15. prints one JSON line of per-kernel results (each with its least time on
    the card, ``bound_ms``, from the bytes it must move at 3.35 TB/s and its
    operations at the published peak of their type), and last the
    ``{"ok": true, ...}`` device line.

Before the kernels it reads the bench training cfg with the port's own YAML
reader (no PyYAML); after the host engine it runs ``skoots-torch
--experimental`` (``cli.main``) on the 256^3 phantom, launch counts read,
with the tuned knobs printed and the instance count beside the default
run's; the kernel checks include the bake at the sparse loss's shape. The
training kernels' cases and every row's bound come from
``skoots_tpu_torch.tools.bench_train_kernels``, so this script, that tool
and the card's tests check the same inputs.

Every phase raises on failure; nothing here catches it. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# one roofline and one set of training-kernel cases with the card's tool
from skoots_tpu_torch.tools.bench_train_kernels import (ANISO, bake_bound, bake_cases, bound,
                                                        nbytes, wgrad_bound, wgrad_inputs)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# main path: bench.py geometry (256^2 x 96 forward tiles, no overlap), the
# bench checkpoint's UNeXT widths 32-64-128 and a 512^3 volume
TILE = (256, 256, 96)
VOLUME = (512, 512, 512)
# training path: the bench checkpoint's training crop
TRAIN_CROP = (96, 96, 32)
# host-streaming path: a 256^3 volume (auto picks the host engine up to 256^3)
HOST_VOLUME = (256, 256, 256)
# the thrifty pipeline's assign tile, where it runs the forward again
ASSIGN_TILE = (256, 256, 64)
# the sparse-checkpoint probe's tile geometry: run_inference's for a 512^3
# volume at the CLI defaults (crop 300x300x20, overlap 50x50x5); the card
# is held against the CPU's plain versions on the 128x128x64 block of the
# phantom that three tubes cross, as two 128x128x32 tiles (the full-width
# model takes 10-15 us a voxel on that machine's CPU)
PROBE_TILE, PROBE_OVERLAP = (300, 300, 20), (50, 50, 5)
PROBE_CPU_TILE = (128, 128, 32)
PROBE_CPU_BLOCK = (slice(192, 320), slice(192, 320), slice(192, 256))
# the upsample's inputs: the two decoder stages of the bench tile, of the
# host engine's 256x256x20 tile, of the training crop at batch 2, of the
# thrifty assign tile and of the probe tile
UPSAMPLE_SHAPES = ((1, 64, 64, 24, 128), (1, 128, 128, 48, 64), (1, 64, 64, 5, 128),
                   (1, 128, 128, 10, 64), (2, 24, 24, 8, 128), (2, 48, 48, 16, 64),
                   (1, 64, 64, 16, 128), (1, 128, 128, 32, 64), (1, 75, 75, 5, 128),
                   (1, 150, 150, 10, 64))
# the depthwise conv at every shape the paths give it: ([B, X, Y, Z],
# input channels, output channels, k, dtype): the bench tile's four levels,
# the thrifty assign tile's and the probe tile's, the host engine's
# 256x256x20 tile, the training crop's, then k = 3 at batch 2 on ragged X,
# Y, Z, and one f32 shape (the FP32 kernel)
DWCONV_CASES = (
    ((1, 256, 256, 96), 1, 32, 7, "bf16"), ((1, 256, 256, 96), 32, 32, 7, "bf16"),
    ((1, 128, 128, 48), 64, 64, 7, "bf16"), ((1, 64, 64, 24), 128, 128, 7, "bf16"),
    ((1, 256, 256, 64), 1, 32, 7, "bf16"), ((1, 256, 256, 64), 32, 32, 7, "bf16"),
    ((1, 128, 128, 32), 64, 64, 7, "bf16"), ((1, 64, 64, 16), 128, 128, 7, "bf16"),
    ((1, 300, 300, 20), 1, 32, 7, "bf16"), ((1, 300, 300, 20), 32, 32, 7, "bf16"),
    ((1, 150, 150, 10), 64, 64, 7, "bf16"), ((1, 75, 75, 5), 128, 128, 7, "bf16"),
    ((1, 256, 256, 20), 1, 32, 7, "bf16"), ((1, 256, 256, 20), 32, 32, 7, "bf16"),
    ((1, 128, 128, 10), 64, 64, 7, "bf16"), ((1, 64, 64, 5), 128, 128, 7, "bf16"),
    ((1, 96, 96, 32), 1, 32, 7, "bf16"), ((1, 96, 96, 32), 32, 32, 7, "bf16"),
    ((1, 48, 48, 16), 64, 64, 7, "bf16"), ((1, 24, 24, 8), 128, 128, 7, "bf16"),
    ((2, 40, 36, 20), 32, 32, 3, "bf16"), ((1, 48, 48, 16), 64, 64, 7, "f32"),
)
# the block tail: (V, C, dtype) for the same paths' levels, then V that no
# row tile divides (128 rows a block at C = 32 and 64, 64 at 128) and one
# f32 shape (the FP32 kernel)
TAIL_CASES = (
    (256 * 256 * 96, 32, "bf16"), (128 * 128 * 48, 64, "bf16"), (64 * 64 * 24, 128, "bf16"),
    (256 * 256 * 64, 32, "bf16"), (128 * 128 * 32, 64, "bf16"), (64 * 64 * 16, 128, "bf16"),
    (300 * 300 * 20, 32, "bf16"), (150 * 150 * 10, 64, "bf16"), (75 * 75 * 5, 128, "bf16"),
    (256 * 256 * 20, 32, "bf16"), (128 * 128 * 10, 64, "bf16"), (64 * 64 * 5, 128, "bf16"),
    (96 * 96 * 32, 32, "bf16"), (48 * 48 * 16, 64, "bf16"), (24 * 24 * 8, 128, "bf16"),
    (100003, 32, "bf16"), (12347, 64, "bf16"), (3001, 128, "bf16"), (4173, 64, "f32"),
)
# the LN head: (V, C, N, dtype) at the paths' shapes (the bench tile, the
# thrifty assign tile, the probe tile, the host engine's tile, the training
# crop), then V that no 32-row warp tile divides, N = 8, C = 64, C = N =
# 128 (W in shared memory) and one f32 shape (the FP32 kernel)
LN_HEAD_CASES = (
    (256 * 256 * 96, 32, 32, "bf16"), (256 * 256 * 64, 32, 32, "bf16"),
    (300 * 300 * 20, 32, 32, "bf16"), (256 * 256 * 20, 32, 32, "bf16"),
    (96 * 96 * 32, 32, 32, "bf16"), (100003, 32, 32, "bf16"), (100003, 32, 8, "bf16"),
    (12347, 64, 32, "bf16"), (3001, 128, 128, "bf16"), (4173, 32, 32, "f32"),
)
# the block tail's work on the FP32 pipe, in instructions (issue slots of
# one lane): per hidden value the bias add, three roundings, an erf (about
# 9) and the GELU's 3 -- 16; per channel of the LayerNorm 8 (sum, centre,
# square and sum, scale, affine, round); per output value 7 (bias, layer
# scale and residual with their four roundings)
TAIL_FP32_PER_HIDDEN, TAIL_FP32_PER_LN, TAIL_FP32_PER_OUT = 16, 8, 7
REPEATS = 5
# sparse training (the bench training cfg, IS_SPARSE): steps an epoch of its
# 2 epochs, the background's least distance from a tube, the points of its
# bake (the cfg's MAX_SKELETON_POINTS), and the block of the 256^3 host
# phantom its checkpoint segments
SPARSE_STEPS, SPARSE_BG_DIST, SPARSE_BAKE_POINTS = 8, 6, 256
SPARSE_BLOCK = (slice(64, 192), slice(64, 192), slice(96, 160))
# launches of each forward kernel in one forward of the bench model
FORWARD_KERNELS_PER_TILE = {"dwconv3d": 11, "mlp_block_tail": 10, "ln_head": 1,
                            "upsample2x": 2}
# the hand-written kernels that must run on the tensor cores (bf16)
TENSOR_CORE_KERNELS = ("tail_tc_kernel", "dwconv3d_tc_kernel", "stem_gemm_kernel",
                       "ln_head_tc_kernel", "dwconv3d_wgrad_tc_kernel", "stem_wgrad_tc_kernel")


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def bf16_ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of max(|ref|, rms(ref)): values below
    the tensor's RMS come from cancellation between operands of about that
    size, whose rounding error is an ulp at that size."""
    import torch

    r = ref.float().abs()
    scale = torch.maximum(r, r.square().mean().sqrt())
    _, e = torch.frexp(scale)  # scale = f * 2^e, f in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def _time_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _randn(rng, shape, scale=1.0, dtype=None, device="cuda"):
    import torch

    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    t = t.to(device)
    return t.to(dtype) if dtype is not None else t


def tensor_core_sass(lib_path) -> dict:
    """HMMA / HGMMA instructions of each tensor-core kernel instantiation in
    the built library (``cuobjdump -sass``); raises where one has none."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(%s)I((?:Li\d+E)+)E" % "|".join(TENSOR_CORE_KERNELS), line)
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2))) if m else ""
            name = f"{m.group(1)}<{args}>" if m else None
            if name:
                counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    for kernel in TENSOR_CORE_KERNELS:
        found = {k: v for k, v in counts.items() if k.startswith(kernel + "<")}
        _need(bool(found) and all(v > 0 for v in found.values()),
              f"{kernel}: no tensor-core instructions in the SASS ({found})")
    return counts


def _record(results, name, source, replaces, err, err_abs, tol, unit, ms,
            plain_ms, least, library_ms=None, note=""):
    """Print one kernel-vs-plain comparison, fail above ``tol``, and sum it
    into the kernel's entry of ``results`` (times and bounds add up over
    the shapes checked; ``bound_by`` is the largest shape's)."""
    ok = err <= tol
    lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
    print(f"kernel {name}: max err {err:.6g} {unit} (bound {tol:g}) "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms{lib} "
          f"least {least[0]:.4f} ms ({least[1]}){note} {'ok' if ok else 'FAIL'}", flush=True)
    _need(ok, f"{name}: error {err} {unit} above bound {tol}")
    for r in results:
        if r["name"] == name:
            r["max_abs_err"] = max(r["max_abs_err"], err_abs)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            if least[0] > r["_largest"]:
                r["_largest"], r["bound_by"] = least
            r["bound_ms"] += least[0]
            if library_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
            return
    results.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": least[0], "bound_by": least[1],
                    "library_ms": library_ms, "_largest": least[0]})


def check_kernels() -> list:
    """Kernel vs plain version on the card at the main-path shapes."""
    import torch
    import torch.nn.functional as F

    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref
    from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_ref, xla_ln_head
    from skoots_tpu_torch.kernels.mlp import (
        mlp_block_tail,
        mlp_block_tail_ref,
        xla_tail,
    )
    from skoots_tpu_torch.kernels.propagate import launch_plan, propagate, propagate_ref
    from skoots_tpu_torch.kernels.upsample import upsample2x, upsample2x_ref
    from skoots_tpu_torch.tools.bench_propagate import (
        SPARSE_PASSES,
        active_share,
        default_tile,
        sparse_bound_ms,
        sparse_case,
    )

    rng = np.random.default_rng(SEED)
    bf = torch.bfloat16
    results = []

    def record(*args, **kwargs):
        _record(results, *args, **kwargs)

    # 1. depthwise conv (DWCONV_CASES): bf16 within 1 bf16 ulp of
    #    max(|plain|, rms(plain)), f32 within 1e-5 of max|plain| (f32 sums
    #    of the same products in another order). Least work: bf16 taps on
    #    the tensor cores (each product of two bf16 values is exact in f32),
    #    f32 taps on the FP32 pipe. Library call: cuDNN's conv3d on the
    #    channels-last view (grouped per channel; the stem a dense 1 -> C)
    for shape, cin, c, k, dtn in DWCONV_CASES:
        dt = bf if dtn == "bf16" else torch.float32
        x = _randn(rng, (*shape, cin), dtype=dt)
        w = _randn(rng, (k, k, k, c), 1 / np.sqrt(k ** 3)).to(dt).float()
        b = _randn(rng, (c,), 0.1).to(dt).float()
        got = dwconv3d(x, w, b)
        ref = dwconv3d_ref(x, w, b)
        torch.cuda.synchronize()
        err_abs = float((got.float() - ref.float()).abs().max())
        if dt == bf:
            err, tol, unit = bf16_ulps(got, ref), 1.0, "bf16 ulp"
            ops = {"tensor_flops": 2.0 * k ** 3 * got.numel()}
        else:
            err, tol, unit = err_abs / float(ref.abs().max()), 1e-5, "of max|plain|"
            ops = {"fp32_flops": 2.0 * k ** 3 * got.numel()}
        xv = x.permute(0, 4, 1, 2, 3)
        wl = w.permute(3, 0, 1, 2).unsqueeze(1).to(dt).contiguous()
        bl = b.to(dt)
        groups = 1 if cin == 1 else c
        record("dwconv3d", "skoots_tpu_torch/csrc/dwconv.cu",
               "skoots_tpu/kernels/dwconv.py:334", err, err_abs, tol,
               f"{unit} at {tuple(x.shape)}->{c} k={k} {dtn}",
               _time_ms(lambda: dwconv3d(x, w, b)),
               _time_ms(lambda: dwconv3d_ref(x, w, b)),
               bound(nbytes(x, w, b, got), **ops),
               _time_ms(lambda: F.conv3d(xv, wl, bl, padding=k // 2, groups=groups)))
        del x, got, ref, xv

    # 2. fused block tail (TAIL_CASES); bound atol 4e-3, rtol 1e-3. Least
    #    work: the bytes, the two products on the tensor cores, and the
    #    LayerNorm, GELU and roundings on the FP32 pipe (TAIL_FP32_*). The
    #    plain composition xla_tail (two cuBLAS GEMMs and elementwise
    #    kernels) is timed as a yardstick: no single library call computes
    #    the function, so the JSON line's library_ms stays null
    for v, c, dtn in TAIL_CASES:
        dt = bf if dtn == "bf16" else torch.float32
        x = _randn(rng, (v, c), dtype=dt)
        s = _randn(rng, (v, c), 0.1, dtype=dt)
        ls = _randn(rng, (c,), 0.1) + 1.0
        lb = _randn(rng, (c,), 0.1)
        w1 = _randn(rng, (c, 4 * c), 1 / np.sqrt(c), dtype=dt)
        b1 = _randn(rng, (4 * c,), 0.1)
        w2 = _randn(rng, (4 * c, c), 1 / np.sqrt(4 * c), dtype=dt)
        b2 = _randn(rng, (c,), 0.1)
        g = torch.full((c,), 0.1, device="cuda")
        args = (x, s, ls, lb, w1, b1, w2, b2, g)
        got = mlp_block_tail(*args)
        ref = mlp_block_tail_ref(*args)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err_abs = float(diff.max())
        excess = float((diff - 1e-3 * ref.float().abs()).max())
        fp32 = v * c * (4 * TAIL_FP32_PER_HIDDEN + TAIL_FP32_PER_LN + TAIL_FP32_PER_OUT)
        if dt == bf:
            ops = {"tensor_flops": 16.0 * v * c * c, "fp32_flops": 2.0 * fp32}
        else:
            ops = {"fp32_flops": 16.0 * v * c * c + 2.0 * fp32}
        comp_ms = _time_ms(lambda: xla_tail(*args))
        record("mlp_block_tail", "skoots_tpu_torch/csrc/mlp.cu",
               "skoots_tpu/kernels/mlp.py:99", excess, err_abs, 4e-3,
               f"(|d| - 1e-3|ref|) at V={v} C={c} {dtn}",
               _time_ms(lambda: mlp_block_tail(*args)),
               _time_ms(lambda: mlp_block_tail_ref(*args)),
               bound(nbytes(*args, got), **ops), note=f" composition {comp_ms:.3f} ms")
        del args, x, s, got, ref, diff

    # 3. fused final LN + 1x1 head (LN_HEAD_CASES): equal to the plain
    #    version (bf16: the tensor cores' sums whose rounding their order could
    #    change are recomputed in the plain order; f32: the plain order). Least
    #    work: the bytes, the products on the tensor cores (bf16) or the FP32
    #    pipe (f32), and the LayerNorm on the FP32 pipe (TAIL_FP32_PER_LN).
    #    The plain composition xla_ln_head (a cuBLAS GEMM and elementwise
    #    kernels) is timed as a yardstick: no single library call computes
    #    the function, so the JSON line's library_ms stays null
    for v, c, n, dtn in LN_HEAD_CASES:
        dt = bf if dtn == "bf16" else torch.float32
        x = _randn(rng, (v, c), dtype=dt)
        ls = _randn(rng, (c,), 0.1) + 1.0
        lb = _randn(rng, (c,), 0.1)
        w = _randn(rng, (c, n), 1 / np.sqrt(c), dtype=dt)
        b = _randn(rng, (n,), 0.1)
        args = (x, ls, lb, w, b)
        got = ln_head(*args)
        ref = ln_head_ref(*args)
        torch.cuda.synchronize()
        differing = int((got != ref).sum())
        err_abs = float((got.float() - ref.float()).abs().max())
        fp32 = 2.0 * v * c * TAIL_FP32_PER_LN
        if dt == bf:
            ops = {"tensor_flops": 2.0 * v * c * n, "fp32_flops": fp32}
        else:
            ops = {"fp32_flops": 2.0 * v * c * n + fp32}
        comp_ms = _time_ms(lambda: xla_ln_head(*args))
        record("ln_head", "skoots_tpu_torch/csrc/lnhead.cu",
               "skoots_tpu/kernels/lnhead.py:53", float(differing), err_abs, 0.0,
               f"values differing ({bf16_ulps(got, ref):.3g} bf16 ulp) at V={v} "
               f"C={c}->{n} {dtn}",
               _time_ms(lambda: ln_head(*args)), _time_ms(lambda: ln_head_ref(*args)),
               bound(nbytes(*args, got), **ops), note=f" composition {comp_ms:.3f} ms")
        del args, x, got, ref

    # 4. label propagation, Q = 4 passes, 26-conn, over the whole volume;
    #    exact. Foreground: 30% random voxels, which percolate, so labels
    #    keep moving in every pass
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fg = (torch.rand(VOLUME, device="cuda", generator=gen) < 0.3).to(torch.uint8)
    idx = torch.arange(1, fg.numel() + 1, dtype=torch.int32, device="cuda")
    lab = torch.where(fg > 0, idx.view(VOLUME), 0)

    def plain4():
        out = lab
        for _ in range(4):
            out = propagate_ref(out, fg)
        return out

    got = propagate(lab, fg, passes=4)
    ref = plain4()
    torch.cuda.synchronize()
    err_abs = float((got != ref).sum())
    # least time of the 4-pass function: labels and mask read once, labels
    # written once (the integer maxima are far below the bytes' time)
    record("propagate", "skoots_tpu_torch/csrc/propagate.cu",
           "skoots_tpu/kernels/propagate.py:93", err_abs, err_abs, 0.0,
           f"voxels differing at {VOLUME} Q=4",
           _time_ms(lambda: propagate(lab, fg, passes=4)), _time_ms(plain4),
           bound(nbytes(lab, fg, got)))
    del lab, fg, got, ref, idx

    # 4b. the main path's case: one CC round (192 passes, 26-conn) on the
    #     bench phantom's dilated skeleton (tools/bench_propagate.py); exact.
    #     Least time: the mask read and the labels written once, and 8 B per
    #     foreground voxel and pass
    lab, fg = sparse_case("cuda")

    def plain_round():
        out = lab
        for _ in range(SPARSE_PASSES):
            out = propagate_ref(out, fg)
        return out

    got = propagate(lab, fg, passes=SPARSE_PASSES)
    ref = plain_round()
    torch.cuda.synchronize()
    err_abs = float((got != ref).sum())
    record("propagate", "skoots_tpu_torch/csrc/propagate.cu",
           "skoots_tpu/kernels/propagate.py:93", err_abs, err_abs, 0.0,
           f"voxels differing at {VOLUME} {SPARSE_PASSES} passes, {int(fg.sum())} fg "
           f"voxels, {active_share(fg, default_tile()):.4f} of tiles active, "
           f"{len(launch_plan(SPARSE_PASSES))} launches",
           _time_ms(lambda: propagate(lab, fg, passes=SPARSE_PASSES)), _time_ms(plain_round),
           (sparse_bound_ms(fg, SPARSE_PASSES), "bytes"))
    del lab, fg, got, ref
    torch.cuda.empty_cache()

    # 5. 2x trilinear upsample at the decoder shapes of the bench tile, the
    #    host engine's tile and the training crop (batch 2), bf16 and f32:
    #    0 differing bits. Least work: read the input, write the output and
    #    the separable cascade's 3 operations per blend (42 per input
    #    element). Library call: F.interpolate on the channels-last view
    #    (the same function, computed another way)
    for shape in UPSAMPLE_SHAPES:
        for dt in (bf, torch.float32):
            x = _randn(rng, shape, dtype=dt)
            got = upsample2x(x)
            ref = upsample2x_ref(x)
            torch.cuda.synchronize()
            bits = int((got != ref).sum())
            err_abs = float((got.float() - ref.float()).abs().max())
            xv = x.permute(0, 4, 1, 2, 3)
            record("upsample2x", "skoots_tpu_torch/csrc/upsample.cu",
                   "skoots_tpu/kernels/upsample.py:98", float(bits), err_abs, 0.0,
                   f"values differing at {shape} {str(dt)[6:]}",
                   _time_ms(lambda: upsample2x(x)), _time_ms(lambda: upsample2x_ref(x)),
                   bound(nbytes(x, got), fp32_flops=42.0 * x.numel()),
                   _time_ms(lambda: F.interpolate(xv, scale_factor=2, mode="trilinear",
                                                  align_corners=False)))
            del x, got, ref, xv
    torch.cuda.empty_cache()
    return results


def check_microbenchmarks(results: list) -> None:
    """The two microbenchmarks through their tools, with the launch counts
    set to 0 before and read after: every row is checked against its plain
    version inside the tool. The kernel rows of the JSON line sum the
    card-filling runs (f32 FMA chain; the four load + FMA variants)."""
    import torch

    from skoots_tpu_torch.kernels.microbench import (
        N_ITER,
        SHAPE,
        fma_chain,
        fma_chain_ref,
        loadfma,
        loadfma_ref,
    )
    from skoots_tpu_torch.tools import bench_fma_rate, bench_loadfma

    fma_chain.launches = loadfma.launches = 0
    fma_rows = bench_fma_rate.measure(repeats=REPEATS)
    lf_rows = bench_loadfma.measure(repeats=REPEATS)
    torch.cuda.synchronize()
    launches = {"fma_chain": fma_chain.launches, "loadfma": loadfma.launches}
    print(f"microbenchmark launches {json.dumps(launches)}", flush=True)

    def once_ms(fn) -> float:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    # the plain versions on the same work, timed once (the f32 chain is
    # 8192 steps of an exact FMA built from f64 operations)
    fill = [r for r in fma_rows if r["dtype"] == "float32" and r["chains"] > 1]
    n = fill[0]["shape"][0]
    a = torch.full((n,), 1.000001, device="cuda")
    b = torch.full((n,), 0.9999, device="cuda")
    fma_plain = [once_ms(lambda: fma_chain_ref(a, b, N_ITER))]
    big = [r for r in lf_rows if r["reps"] > 1]
    rng = np.random.default_rng(SEED)
    buf = torch.from_numpy(rng.integers(-8, 9, SHAPE).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.integers(-8, 9, (1, 128)).astype(np.float32)).cuda()
    lf_plain = []
    for r in big:
        dyn, ch = r["variant"].startswith("dynamic"), 8 if "chains" in r["variant"] else 1
        lf_plain.append(once_ms(lambda: loadfma_ref(buf.expand(r["reps"], *SHAPE), w,
                                                    dyn, ch)))
    for name, replaces, rows, plain in (
            ("fma_chain", "tools/bench_vpu_pallas.py:33", fill, fma_plain),
            ("loadfma", "tools/bench_loadfma.py:88", big, lf_plain)):
        _need(launches[name] > 0 and rows, f"{name} did not run")
        print(f"kernel {name}: {sum(r['ms'] for r in rows):.4f} ms on the card-filling "
              f"runs, plain {sum(plain):.3f} ms", flush=True)
        results.append({
            "name": name, "route": "cuda", "source": "skoots_tpu_torch/csrc/microbench.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": 0.0,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(plain),
            "bound_ms": sum(bound(0, fp32_flops=r["flops"])[0] for r in rows),
            "bound_by": "operations", "library_ms": None, "_largest": 0.0})


def _iou_match(ref, other):
    """(instances of ``ref``, of ``other``, min over ``ref``'s instances of
    the IoU with its best-overlapping instance of ``other``)."""
    ids = [i for i in np.unique(ref) if i]
    ious = []
    for i in ids:
        m = ref == i
        cand, cnt = np.unique(other[m], return_counts=True)
        j = cand[np.argmax(np.where(cand > 0, cnt, -1))]
        ious.append(float((m & (other == j)).sum()) / float((m | (other == j)).sum())
                    if j else 0.0)
    return len(ids), len(np.unique(other)) - (1 if (other == 0).any() else 0), \
        min(ious, default=0.0)


def _no_plain_propagation(*args, **kwargs):
    raise RuntimeError("the plain propagation ran on the card")


def _launch_counters():
    """The wrappers of the forward kernels and propagate, by name."""
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.kernels.dwconv import dwconv3d
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x

    return {"dwconv3d": dwconv3d, "mlp_block_tail": mlp_block_tail,
            "ln_head": ln_head, "upsample2x": upsample2x,
            "propagate": prop_mod.propagate}


def run_host_engine(results: list):
    """The host-streaming engine through ``run_inference`` at its defaults
    on a seeded 256^3 tube phantom (uint8 ``.npy``) with the bench
    checkpoint, then its ``--use-cached`` and out-of-core reruns, then a
    128x128x32 block on the card and on the CPU. Returns the phantom, the
    default run's instance count and the tubes placed."""
    import shutil

    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    work = os.path.join(ROOT, "build", "host_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    shape = HOST_VOLUME
    n_target = max(6, int(48 * (shape[0] * shape[1] * shape[2]) / 512**3))
    p0, p1, n_expected = tube_segments(shape, n_target, radius=5.0, seed=7)
    vol = render_tubes(shape, p0, p1, radius=5.0, device="cuda").round()
    vol = vol.to(torch.uint8).cpu().numpy()
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol)
    print(f"host engine: phantom {shape} uint8, {n_expected} tubes placed", flush=True)

    kernels = _launch_counters()
    per_forward = FORWARD_KERNELS_PER_TILE

    def run(tag, **kw):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        saved, prop_mod.propagate_ref = prop_mod.propagate_ref, _no_plain_propagation
        try:
            t0 = time.time()
            mask = engine.run_inference(path, ckpt, output_path=os.path.join(
                work, f"mask_{tag}.npy"), **kw)
            torch.cuda.synchronize()
            e2e = time.time() - t0
        finally:
            prop_mod.propagate_ref = saved
        counts = {name: fn.launches for name, fn in kernels.items()}
        stats = json.loads(json.dumps(engine.last_stats))
        mask = np.asarray(mask)
        n = len(np.unique(mask)) - 1
        print(f"host engine [{tag}]: {n} instances of {n_expected} placed, e2e "
              f"{e2e:.3f} s (run_inference), peak_device_memory_bytes "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
        print(f"host engine [{tag}] stages: {json.dumps(stats)}", flush=True)
        print(f"host engine [{tag}] launches: {json.dumps(counts)}", flush=True)
        _need(stats["engine"] == "host", f"[{tag}] ran the {stats['engine']} engine")
        _need(counts["propagate"] == stats["phase2"]["cc_rounds"] > 0,
              f"[{tag}] propagate launches {counts['propagate']} against "
              f"{stats['phase2']['cc_rounds']} CC rounds")
        return mask, counts, stats

    # 1. defaults: auto -> host (256^3), store, the dilation probe on 4 tiles
    mask, counts, stats = run("defaults")
    forwards = 4 + stats["phase1"]["tiles"]
    for name, k in per_forward.items():
        _need(counts[name] == k * forwards,
              f"{name}: {counts[name]} launches, expected {k} x {forwards} forwards")
    n = n_default = len(np.unique(mask)) - 1
    _need(0.8 * n_expected <= n <= n_expected + 4,
          f"n_instances {n} outside [0.8*{n_expected}, {n_expected}+4]")
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    knobs = json.load(open(os.path.join(work, "phantom_skoots_phase1.json")))

    # 2. the phase-1 cache: no forward, the same mask
    cached, counts, _ = run("use_cached", use_cached_data=True)
    _need(all(counts[k] == 0 for k in per_forward), "the cached rerun ran the model")
    _need(np.array_equal(cached, mask), "the --use-cached rerun's mask differs")
    print("host engine [use_cached]: mask equal to the first run's", flush=True)

    # 3. out of core: recompute wire mode, memmapped buffers
    ooc, counts, stats = run("out_of_core", out_of_core=True)
    _need(stats["wire_mode"] == "recompute", "out of core did not recompute")
    forwards = 4 + stats["phase1"]["tiles"] + stats["phase3"]["tiles"]
    _need(counts["dwconv3d"] == 11 * forwards, f"out of core: {counts['dwconv3d']} "
          f"dwconv launches, expected 11 x {forwards}")
    n = len(np.unique(ooc)) - 1
    print(f"host engine [out_of_core]: {n} instances, {int((ooc != mask).sum())} voxels "
          f"differ from the first run", flush=True)
    _need(0.8 * n_expected <= n <= n_expected + 4, f"out of core: n_instances {n}")

    # 4. a 128x128x32 block (the one most tubes cross: connected pieces of
    #    over 500 bright voxels) on the card and on the CPU, as one tile with
    #    the first run's dilation stack
    from scipy import ndimage

    best, origin = (-1, -1), None
    for ox in range(0, shape[0] - 127, 32):
        for oy in range(0, shape[1] - 127, 32):
            for oz in range(0, shape[2] - 31, 16):
                bright = vol[ox:ox + 128, oy:oy + 128, oz:oz + 32] > 100
                lab, n = ndimage.label(bright, np.ones((3, 3, 3)))
                pieces = int((np.bincount(lab.ravel())[1:] > 500).sum()) if n else 0
                if (pieces, int(bright.sum())) > best:
                    best, origin = (pieces, int(bright.sum())), (ox, oy, oz)
    ox, oy, oz = origin
    block_path = os.path.join(work, "block.npy")
    np.save(block_path, np.ascontiguousarray(vol[ox:ox + 128, oy:oy + 128, oz:oz + 32]))
    masks = []
    for dev in ("cuda", "cpu"):
        masks.append(np.asarray(engine.run_inference(
            block_path, ckpt, crop_size=(128, 128, 32), overlap=(0, 0, 0),
            dilation_3d=knobs["dilation_3d"], dilation_2d=knobs["dilation_2d"],
            output_path=os.path.join(work, f"block_{dev}.npy"), device=dev)))
    n_cpu, n_card, min_iou = _iou_match(masks[1], masks[0])
    print(f"host engine card vs cpu on the block at {origin}: {n_card} vs {n_cpu} "
          f"instances, min IoU {min_iou:.4f}", flush=True)
    _need(n_cpu >= 1 and n_card == n_cpu and min_iou >= 0.95,
          "the host engine's instances on the card differ from the CPU's")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return vol, n_default, n_expected


def run_slice(results: list):
    """The main path on the bench checkpoint and phantom; returns
    ``(checkpoint, model, phantom, instance mask on the host, the run's
    peak reserved device bytes, the pipeline)`` for
    :func:`check_against_cpu` and :func:`run_thrifty`."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.models import model_from_checkpoint
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    dev = torch.device("cuda")
    t0 = time.time()
    ckpt = load_checkpoint(os.path.join(ROOT, "runs", "bench_ckpt.skoots"))
    model = model_from_checkpoint(ckpt, device=dev)
    cfg = ckpt["cfg"]
    mean = float(ckpt["dataset_mean"])
    std = float(ckpt["dataset_std"])
    shape = VOLUME
    n_target = max(6, int(48 * (shape[0] * shape[1] * shape[2]) / 512**3))
    p0, p1, n_expected = tube_segments(shape, n_target, radius=5.0, seed=7)
    volume = render_tubes(shape, p0, p1, radius=5.0, device=dev)
    torch.cuda.synchronize()
    print(f"setup: checkpoint + phantom {time.time() - t0:.2f} s "
          f"(volume {shape}, {n_expected} tubes placed)", flush=True)

    run = make_chunked_pipeline(
        model, shape, crop=TILE, overlap=(0, 0, 0), assign_crop=(256, 256, 64),
        vector_scale=tuple(cfg["SKOOTS"]["VECTOR_SCALING"]),
        embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
        cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0,
        device=dev,
    )
    kernels = _launch_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    saved, prop_mod.propagate_ref = prop_mod.propagate_ref, _no_plain_propagation
    try:
        t0 = time.time()
        inst = run(volume, mean, std)
        torch.cuda.synchronize()
        e2e = time.time() - t0
    finally:
        prop_mod.propagate_ref = saved
    counts = {name: fn.launches for name, fn in kernels.items()}
    # the run's own peaks, over the phantom and the model it was given:
    # allocated, and reserved (what the card must have free)
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved

    _need(tuple(inst.shape) == shape and inst.dtype == torch.int32,
          f"output {tuple(inst.shape)} {inst.dtype}")
    n_instances = int((torch.unique(inst) > 0).sum())
    print(f"phases: {json.dumps(run.last_phase_s)} e2e {e2e:.3f} s", flush=True)
    print(f"n_instances {n_instances} n_expected {n_expected}", flush=True)
    print(f"cc_rounds {run.last_cc_rounds} cc_converged {run.last_cc_converged}",
          flush=True)
    print(f"inference launches {json.dumps(counts)}", flush=True)
    print(f"peak_device_memory_bytes {peak}, reserved {reserved} (over the {base} B "
          "allocated before the run: the f32 phantom and the model)", flush=True)
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    for name, n in counts.items():
        _need(n > 0, f"kernel {name} was not launched on the main path")
    n_tiles = int(np.prod([-(-v // t) for v, t in zip(shape, TILE)]))
    _need(counts["upsample2x"] == 2 * n_tiles,
          f"upsample2x: {counts['upsample2x']} launches, expected 2 x {n_tiles} tiles")
    per_round = len(prop_mod.launch_plan(192))
    _need(counts["propagate"] == run.last_cc_rounds * per_round,
          f"propagate: {counts['propagate']} launches, expected {run.last_cc_rounds} CC "
          f"rounds x {per_round}")
    _need(0.8 * n_expected <= n_instances <= n_expected + 4,
          f"n_instances {n_instances} outside [0.8*{n_expected}, {n_expected}+4]")
    return ckpt, model, volume, inst.cpu(), reserved, run


def check_against_cpu(ckpt, model, volume) -> None:
    """The same pipeline on a 128x128x64 block of the phantom that three
    tubes cross, on the card and with every kernel's plain version on the
    CPU (which the CPU tests hold against the JAX package): finite model
    output, the same instance count, every instance at IoU >= 0.95."""
    import torch

    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.models import model_from_checkpoint

    block = volume[192:320, 192:320, 192:256].contiguous()
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    out = model(((block - mean) / std)[None, ..., None])
    _need(bool(torch.isfinite(out).all()) and tuple(out.shape) == (1, *block.shape, 5),
          f"model output {tuple(out.shape)} not finite or of the wrong shape")
    masks = []
    for dev, m in ((torch.device("cuda"), model),
                   (torch.device("cpu"), model_from_checkpoint(ckpt, device="cpu"))):
        run = make_chunked_pipeline(
            m, tuple(block.shape), crop=TILE, overlap=(0, 0, 0),
            assign_crop=(256, 256, 64),
            vector_scale=tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]),
            embed_iterations=10, embed_compact_div=16, cc_rounds=24,
            cc_propagates_per_round=192, cc_jumps_per_round=0, device=dev)
        masks.append(run(block.to(dev), mean, std).cpu().numpy())
    card, cpu = masks
    ids = [i for i in np.unique(cpu) if i]
    ious = []
    for i in ids:
        m = cpu == i
        cand, cnt = np.unique(card[m], return_counts=True)
        j = cand[np.argmax(np.where(cand > 0, cnt, -1))]
        ious.append(float((m & (card == j)).sum()) / float((m | (card == j)).sum())
                    if j else 0.0)
    n_card = len(np.unique(card)) - 1
    print(f"card vs cpu on {tuple(block.shape)}: {n_card} vs {len(ids)} instances, "
          f"min IoU {min(ious, default=0.0):.4f}", flush=True)
    _need(len(ids) >= 1 and n_card == len(ids) and min(ious) >= 0.95,
          "the card's instances differ from the plain versions' on the CPU")


def run_thrifty(results: list, ckpt, model, volume, chunked, chunked_peak,
                chunked_run) -> None:
    """The device-thrifty pipeline on the bench phantom as ``skoots
    --image`` gives it one, a uint8 host array (the phantom rounded), with
    the main path's knobs, launch counts set to 0 just before and read just
    after (every forward kernel per forward of its tile plan, propagate per
    CC round, the plain propagation barred); its peak device memory over
    what was allocated before, held against ``estimated_device_bytes``
    with one forward tile's peak measured as ``auto`` measures it; a
    second, warm run (the same mask), then the chunked pipeline again, for
    times taken in turns; then ``skoots-validate``'s metrics on the card
    with the thrifty mask as the prediction and the chunked pipeline's as
    the ground truth, F1@0.5 >= 0.95, and the card's IoU, Dice and clDice
    tables held against the same functions on the CPU. Returns the uint8
    phantom and the tile's peak bytes for :func:`run_thrifty_engine`."""
    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.device_pipeline import (
        estimated_device_bytes,
        make_thrifty_pipeline,
    )
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.ops.flood_fill import (
        _compact_labels,
        make_label_components_stepped,
        widen_u16,
    )
    from skoots_tpu_torch.utils.synthetic import tube_segments
    from skoots_tpu_torch.validate import metrics
    from skoots_tpu_torch.validate.cli import run_validation

    dev = torch.device("cuda")
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    n_expected = tube_segments(VOLUME, 48, radius=5.0, seed=7)[2]
    vol_u8 = volume.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    vox = int(np.prod(VOLUME))
    run = make_thrifty_pipeline(
        model, VOLUME, crop=TILE, overlap=(0, 0, 0), assign_crop=ASSIGN_TILE,
        vector_scale=tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]),
        embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
        cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0,
        device=dev,
    )
    torch.cuda.empty_cache()
    tile_bytes = engine._forward_tile_bytes(model, [TILE, ASSIGN_TILE], 0.8, 0.8, 1, 2,
                                            dev)
    kernels = _launch_counters()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    saved, prop_mod.propagate_ref = prop_mod.propagate_ref, _no_plain_propagation
    try:
        t0 = time.time()
        inst = run(vol_u8, mean, std)
        torch.cuda.synchronize()
        e2e = time.time() - t0
    finally:
        prop_mod.propagate_ref = saved
    counts = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved
    labels = widen_u16(inst)
    ids = torch.unique(labels)
    n_instances = int((ids > 0).sum())
    est = estimated_device_bytes(VOLUME, thrifty=True, itemsize=1, tile_bytes=tile_bytes)
    est_chunked = estimated_device_bytes(VOLUME, tile_bytes=tile_bytes)
    print(f"thrifty (uint8 host volume) phases: {json.dumps(run.last_phase_s)} e2e "
          f"{e2e:.3f} s", flush=True)
    print(f"thrifty n_instances {n_instances} n_expected {n_expected} components "
          f"{run.last_count} mask {inst.dtype} cc_rounds {run.last_cc_rounds} "
          f"cc_converged {run.last_cc_converged}", flush=True)
    print(f"thrifty launches {json.dumps(counts)} tile plan {json.dumps(run.tile_plan)}",
          flush=True)
    print(f"thrifty peak_device_memory_bytes {peak}, reserved {reserved} (over {base} B "
          f"allocated before); one forward tile reserves {tile_bytes} B; beyond it "
          f"{(reserved - tile_bytes) / vox:.3f} B a voxel reserved (estimate 13), "
          f"estimate {est} B; chunked (f32 phantom on the card) reserved {chunked_peak}, "
          f"{(chunked_peak - tile_bytes) / vox:.3f} B a voxel beyond the tile (estimate "
          f"24), estimate {est_chunked} B", flush=True)
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    _need(reserved <= est, f"thrifty reserved {reserved} B over its estimate {est} B")
    _need(chunked_peak <= est_chunked,
          f"chunked reserved {chunked_peak} B over its estimate {est_chunked} B")
    _need(tuple(inst.shape) == VOLUME, f"thrifty output {tuple(inst.shape)}")
    _need(inst.dtype == (torch.uint16 if run.last_count < 2**16 else torch.int32),
          f"thrifty mask {inst.dtype} for {run.last_count} components")
    _need(int(ids[0]) == 0 and int(ids[-1]) <= run.last_count,
          f"thrifty labels up to {int(ids[-1])}, not numbered 1..{run.last_count}")
    forwards = run.tile_plan["forward"] + run.tile_plan["assign"]
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == k * forwards,
              f"thrifty {name}: {counts[name]} launches, expected {k} x {forwards} "
              "forwards")
    per_round = len(prop_mod.launch_plan(192))
    _need(counts["propagate"] == run.last_cc_rounds * per_round > 0,
          f"thrifty propagate: {counts['propagate']} launches, expected "
          f"{run.last_cc_rounds} CC rounds x {per_round}")
    _need(0.8 * n_expected <= n_instances <= n_expected + 4,
          f"thrifty n_instances {n_instances} outside [0.8*{n_expected}, {n_expected}+4]")
    # phase 2 alone, where the per-voxel term peaks: the CC and the 16-bit
    # compaction on the mask of the thrifty instances, over that mask
    fg = (labels > 0).to(torch.uint8)
    cc = make_label_components_stepped(VOLUME, rounds_per_dispatch=1,
                                       propagates_per_round=192, jumps_per_round=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    compact, n_cc = _compact_labels(cc(fg, max_rounds=24), narrow16=True)
    torch.cuda.synchronize()
    cc_peak = torch.cuda.max_memory_reserved() - base_reserved
    # the pipeline holds the uint8 volume and the mask beside it
    cc_per_voxel = cc_peak / vox + 2
    print(f"thrifty phase 2 alone (CC {cc.last_rounds} rounds + compaction to {n_cc} "
          f"labels, {compact.dtype}): {cc_peak} B reserved over the mask, "
          f"{cc_per_voxel:.3f} B a voxel with the volume and the mask (estimate 13)",
          flush=True)
    _need(cc_per_voxel <= 13, f"thrifty phase 2 takes {cc_per_voxel:.3f} B a voxel")
    del fg, compact
    for name, again, vol in (("thrifty", run, vol_u8), ("chunked", chunked_run, volume)):
        torch.cuda.synchronize()
        t0 = time.time()
        out = again(vol, mean, std)
        torch.cuda.synchronize()
        print(f"{name} again: phases {json.dumps(again.last_phase_s)} e2e "
              f"{time.time() - t0:.3f} s", flush=True)
        if again is run:
            _need(torch.equal(widen_u16(out), labels),
                  "the thrifty pipeline's second mask differs")
        del out
    torch.cuda.empty_cache()

    work = os.path.join(ROOT, "build", "validate_smoke")
    os.makedirs(work, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.time()
    res = run_validation(chunked, labels, os.path.join(work, "thrifty"),
                         plots=False, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"validate (thrifty vs chunked, card): F1@0.5 {res['f1@50']:.6f} mean IoU "
          f"{res['mean_iou']:.6f} mean clDice {res['mean_cldice']:.6f} over-seg "
          f"{res['over_segmentation_rate']:.4f} under-seg "
          f"{res['under_segmentation_rate']:.4f} in {dt:.3f} s", flush=True)
    _need(res["f1@50"] >= 0.95, f"thrifty vs chunked F1@0.5 {res['f1@50']} < 0.95")
    pred = labels.cpu()
    for fn in ("mask_iou", "mask_dice", "mask_soft_cldice"):
        card = getattr(metrics, fn)(chunked, labels, device=dev).cpu()
        cpu = getattr(metrics, fn)(chunked, pred, device="cpu")
        err = float((card - cpu).abs().max()) if card.numel() else 0.0
        tol = 1e-5 if fn == "mask_soft_cldice" else 0.0
        print(f"validate {fn}: card vs cpu {tuple(card.shape)} max |d| {err:.3g} "
              f"(bound {tol:g})", flush=True)
        _need(card.shape == cpu.shape and err <= tol,
              f"{fn}: the card's table differs from the CPU's by {err}")
    shutil.rmtree(work, ignore_errors=True)
    del inst, labels
    torch.cuda.empty_cache()
    return vol_u8, tile_bytes


def run_thrifty_engine(results: list, vol_u8, tile_bytes: int) -> None:
    """``run_inference`` on the uint8 phantom (an ``.npy``, as ``skoots
    --image`` reads one) with the bench checkpoint: first with
    ``engine_impl="device-thrifty"``, then with ``auto`` on a card whose
    free memory a ballast tensor cuts to halfway between the thrifty and
    the chunked estimates, where ``auto`` must take the thrifty pipeline
    and finish. Launch counts set to 0 just before each run and read just
    after: each forward kernel per forward (the 4 dilation-probe tiles,
    ``auto``'s one measured tile, the pipeline's tile plan), propagate per
    CC round; the phases JSON's engine, the instance count."""
    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.device_pipeline import estimated_device_bytes
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.utils.synthetic import tube_segments

    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    work = os.path.join(ROOT, "build", "thrifty_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol_u8)
    n_expected = tube_segments(VOLUME, 48, radius=5.0, seed=7)[2]
    dev = torch.device("cuda")
    kernels = _launch_counters()

    def run(tag, engine_impl, measured_tiles):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        saved, prop_mod.propagate_ref = prop_mod.propagate_ref, _no_plain_propagation
        try:
            t0 = time.time()
            mask = engine.run_inference(path, ckpt, engine_impl=engine_impl,
                                        output_path=os.path.join(work, f"mask_{tag}.npy"))
            torch.cuda.synchronize()
            e2e = time.time() - t0
        finally:
            prop_mod.propagate_ref = saved
        counts = {name: fn.launches for name, fn in kernels.items()}
        with open(os.path.join(work, "phantom_skoots_phases.json")) as f:
            stats = json.load(f)
        n = len(np.unique(mask)) - 1
        print(f"run_inference [{tag}]: {n} instances of {n_expected} placed, e2e "
              f"{e2e:.3f} s; phases {json.dumps(stats)}; launches {json.dumps(counts)}",
              flush=True)
        for r in results:
            r["launches"] += counts.get(r["name"], 0)
        _need(stats["engine"] == "device-thrifty",
              f"[{tag}] ran the {stats['engine']} engine, not device-thrifty")
        forwards = 4 + measured_tiles + sum(stats["tile_plan"].values())
        for name, k in FORWARD_KERNELS_PER_TILE.items():
            _need(counts[name] == k * forwards,
                  f"[{tag}] {name}: {counts[name]} launches, expected {k} x {forwards}")
        # run_inference's CC: the pipeline's default 128 passes a round
        per_round = len(prop_mod.launch_plan(128))
        _need(counts["propagate"] == stats["cc_rounds"] * per_round > 0,
              f"[{tag}] propagate: {counts['propagate']} launches, expected "
              f"{stats['cc_rounds']} CC rounds x {per_round}")
        _need(0.8 * n_expected <= n <= n_expected + 4,
              f"[{tag}] n_instances {n} outside [0.8*{n_expected}, {n_expected}+4]")
        return stats

    run("device-thrifty", "device-thrifty", 0)

    est = {"device": estimated_device_bytes(VOLUME, tile_bytes=tile_bytes),
           "device-thrifty": estimated_device_bytes(VOLUME, thrifty=True, itemsize=1,
                                                    tile_bytes=tile_bytes)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    target = (est["device"] + est["device-thrifty"]) // 2
    ballast = torch.empty(engine._device_bytes_limit(dev) - target, dtype=torch.uint8,
                          device=dev)
    print(f"auto: a {ballast.numel()} B ballast leaves {engine._device_bytes_limit(dev)} B "
          f"free (estimates {json.dumps(est)})", flush=True)
    try:
        stats = run("auto", "auto", 1)
    finally:
        del ballast
        torch.cuda.empty_cache()
    auto = stats["auto"]
    _need(auto["estimated_bytes"]["device-thrifty"] <= auto["free_bytes"]
          < auto["estimated_bytes"]["device"],
          f"auto: free {auto['free_bytes']} B not between the estimates "
          f"{json.dumps(auto['estimated_bytes'])}")
    shutil.rmtree(work, ignore_errors=True)


def check_sparse_probe(results: list, ckpt, model, volume) -> None:
    """``infer.engine._probe_semantic_threshold`` (the sparse checkpoint's
    gate) with the bench model on the phantom at ``run_inference``'s probe
    geometry for 512^3, launch counts set to 0 just before and read just
    after (each forward kernel per probe tile); held against the same
    function on the CPU with the plain versions and the checkpoint's dtype
    on a block three tubes cross: the same histogram bin, or None on
    both."""
    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.autoknobs import calibrate_semantic_threshold_from_histogram
    from skoots_tpu_torch.models import model_from_checkpoint

    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    vol = volume.cpu().numpy()[..., None]
    kernels = _launch_counters()
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    thr = engine._probe_semantic_threshold(model, mean, std, vol, PROBE_TILE,
                                           PROBE_OVERLAP, "cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    print(f"sparse probe (card): threshold {thr} in {dt:.3f} s, launches "
          f"{json.dumps(counts)}", flush=True)
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == 4 * k,
              f"probe {name}: {counts[name]} launches, expected {k} x 4 tiles")

    def bin_width(probs):
        """The logit width of the calibration histogram's bins."""
        v = probs[probs > 0.5]
        t = np.log(np.clip(v, 1e-6, 1 - 1e-7)) - np.log(np.clip(1 - v, 1e-7, 1))
        return (t.max() - t.min()) / 128 if v.size else 0.0

    def logit(p):
        return float(np.log(p) - np.log1p(-p))

    block = np.ascontiguousarray(vol[PROBE_CPU_BLOCK])

    def probe(m, device):
        probs = engine._probe_probabilities(m, mean, std, block, PROBE_CPU_TILE,
                                            (0, 0, 0), device)
        return calibrate_semantic_threshold_from_histogram(probs), probs

    card_thr, card_probs = probe(model, "cuda")
    print(f"sparse probe (card, {block.shape[:3]} block): threshold {card_thr}, "
          f"{int((card_probs > 0.5).sum())} values above 0.5, "
          f"{int((card_probs == 1.0).sum())} equal to 1, bin width "
          f"{bin_width(card_probs):.4f}", flush=True)
    # the checkpoint's own dtype (bf16) must land in the card's bin; an f32
    # copy is printed beside it but not held: bf16 probabilities above 0.5
    # come in steps of 2^-8 and mostly saturate at 1, so its histogram's
    # range, and with it the valley, differs
    model_dtype = ckpt["cfg"]["MODEL"]["DTYPE"]
    cpu_ckpt = {**ckpt, "cfg": {**ckpt["cfg"]}}
    for dtype in ("float32", model_dtype):
        cpu_ckpt["cfg"]["MODEL"] = {**ckpt["cfg"]["MODEL"], "DTYPE": dtype}
        cpu_model = model_from_checkpoint(cpu_ckpt, device="cpu")
        t0 = time.time()
        cpu_thr, probs = probe(cpu_model, "cpu")
        same = (card_thr is None and cpu_thr is None) or (
            card_thr is not None and cpu_thr is not None
            and abs(logit(card_thr) - logit(cpu_thr)) <= bin_width(probs))
        print(f"sparse probe (cpu, {dtype} model): threshold {cpu_thr} in "
              f"{time.time() - t0:.1f} s, bin width {bin_width(probs):.4f}, "
              f"{int((probs == 1.0).sum())} equal to 1; same bin as the card: {same}",
              flush=True)
    _need(same, f"probe: the card's threshold {card_thr} and the CPU's {cpu_thr} "
          f"({model_dtype}) are not in one histogram bin")


def check_train_kernels(results: list) -> None:
    """The training path's kernels against their plain versions at its
    shapes (crop 96x96x32 and its two coarser levels), and the autograd
    wiring of the block tail and LN head."""
    import torch

    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad, dwconv3d_wgrad_ref
    from skoots_tpu_torch.kernels.lnhead import ln_head, xla_ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail, xla_tail

    # the training path's cases draw from rng in the order of the checks
    # below since they were first made (so their inputs stay), the added
    # ones from extra
    rng = np.random.default_rng(SEED + 1)
    extra = np.random.default_rng(SEED + 2)
    bf = torch.bfloat16
    cx, cy, cz = TRAIN_CROP

    # 1. depthwise weight gradient (tools/bench_train_kernels.py's cases):
    #    the stem (1 -> 32, channel stride 0) and the three block widths at
    #    their levels (bf16: the tensor-core kernels), a ragged batch of 2
    #    (X, Y, Z no multiple of a tile) for the depthwise and the stem
    #    kernels, and one f32 shape (the FP32 kernel); bound 1e-3 *
    #    max|plain| (f32 sums of the same exact products in another order),
    #    and the same result from run to run (fixed-order sums)
    for name, x, g in wgrad_inputs(rng, extra):
        cin, c = x.shape[-1], g.shape[-1]
        got = dwconv3d_wgrad(x, g, 7)
        ref = dwconv3d_wgrad_ref(x, g, 7)
        torch.cuda.synchronize()
        _need(torch.equal(got, dwconv3d_wgrad(x, g, 7)),
              f"dwconv3d_wgrad {name}: differs run to run")
        err_abs = float((got - ref).abs().max())
        # library call: cuDNN's weight gradient on the channels-last views
        # (grouped per channel; the stem's dense 1 -> 32)
        xv, gv = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        groups = 1 if cin == 1 else c
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            library = _time_ms(lambda: torch.nn.grad.conv3d_weight(
                xv, (c, 1, 7, 7, 7), gv, padding=3, groups=groups))
        _record(results, "dwconv3d_wgrad", "skoots_tpu_torch/csrc/dwconv_wgrad.cu",
                "skoots_tpu/kernels/dwconv.py:782", err_abs / float(ref.abs().max()),
                err_abs, 1e-3, f"of max|plain| at {name} {tuple(x.shape[:4])} {cin}->{c} "
                f"{'bf16' if x.dtype == bf else 'f32'}",
                _time_ms(lambda: dwconv3d_wgrad(x, g, 7)),
                _time_ms(lambda: dwconv3d_wgrad_ref(x, g, 7)),
                wgrad_bound(x, g, got), library)
        del x, g, got, ref, xv, gv

    # 2. skeleton bake over one crop, anisotropy (1, 1, 3), exact: 8 box
    #    instances with P = 256 and 4,096 points inside them; the sparse
    #    loss's bake (every point of a sample as one instance against an
    #    all-ones mask, closest_skeleton; P = the bench cfg's
    #    MAX_SKELETON_POINTS, a quarter of it padding); equidistant
    #    duplicates (the first minimal point decides); 40 ids in every tile
    #    (more than the kernel lists: the full scan with the id compare)
    for name, masks, pts, ids in bake_cases(rng, extra, (cx, cy, cz), SPARSE_BAKE_POINTS):
        masks = masks.cuda()
        pts_t, ids_t = torch.from_numpy(pts).cuda(), torch.from_numpy(ids).cuda()
        got = bake_skeleton_kernel(masks, pts_t, ids_t, ANISO)
        ref = bake_skeleton_ref(masks, pts_t, ids_t, ANISO)
        torch.cuda.synchronize()
        diff = int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
        err_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        _record(results, "bake_skeleton", "skoots_tpu_torch/csrc/bake.cu",
                "skoots_tpu/kernels/bake.py:112", float(diff), err_abs, 0.0,
                f"values differing at {name} V={masks.numel()}",
                _time_ms(lambda: bake_skeleton_kernel(masks, pts_t, ids_t, ANISO)),
                _time_ms(lambda: bake_skeleton_ref(masks, pts_t, ids_t, ANISO)),
                bake_bound(masks, pts_t, ids_t, *got))
        del got, ref, masks

    # 3. the depthwise conv's bf16 input gradient (the forward kernel on the
    #    cotangent with tap-flipped weights) against its plain composition,
    #    at the training levels; 1 bf16 ulp
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref

    for (sx, sy, sz), c in (((cx, cy, cz), 32), ((cx // 2, cy // 2, cz // 2), 64),
                            ((cx // 4, cy // 4, cz // 4), 128)):
        x = _randn(rng, (1, sx, sy, sz, c), dtype=bf).requires_grad_()
        w = _randn(rng, (7, 7, 7, c), 1 / np.sqrt(343)).to(bf).float()
        b = _randn(rng, (c,), 0.1).to(bf).float()
        g = _randn(rng, (1, sx, sy, sz, c), 1e-3, dtype=bf)
        (dx,) = torch.autograd.grad(dwconv3d(x, w, b), x, g)
        want = dwconv3d_ref(g, torch.flip(w, (0, 1, 2)), torch.zeros_like(b))
        torch.cuda.synchronize()
        ulps = bf16_ulps(dx, want)
        print(f"dwconv3d input gradient at {(sx, sy, sz)} C={c} bf16: "
              f"max err {ulps:.3g} bf16 ulp (bound 1)", flush=True)
        _need(dx.dtype == bf and ulps <= 1.0, f"dwconv3d input gradient at C={c}: {ulps} ulp")
        del x, g, dx, want

    # 4. autograd wiring: each wrapper's gradients are exactly the autograd
    #    of its plain composition at the same inputs (the backward
    #    recomputes from them), at the path's widths
    def same_grads(fn, comp, args):
        out = fn(*args)
        g = torch.randn(out.shape, device="cuda").to(out.dtype)
        got = torch.autograd.grad(out, args, g)
        want = torch.autograd.grad(comp(*args), args, g)
        return all(torch.equal(a, b) for a, b in zip(got, want))

    v = cx * cy * cz
    for vv, c in ((v, 32), (v // 8, 64), (v // 64, 128)):
        args = [_randn(rng, (vv, c), dtype=bf), _randn(rng, (vv, c), 0.1, dtype=bf),
                _randn(rng, (c,), 0.1) + 1.0, _randn(rng, (c,), 0.1),
                _randn(rng, (c, 4 * c), 1 / np.sqrt(c)), _randn(rng, (4 * c,), 0.1),
                _randn(rng, (4 * c, c), 1 / np.sqrt(4 * c)), _randn(rng, (c,), 0.1),
                torch.full((c,), 0.5, device="cuda")]
        args = [a.requires_grad_() for a in args]
        ok = same_grads(mlp_block_tail, xla_tail, args)
        print(f"backward mlp_block_tail V={vv} C={c}: "
              f"{'equal' if ok else 'DIFFERENT'}", flush=True)
        _need(ok, f"mlp_block_tail backward differs from its composition at C={c}")
    args = [_randn(rng, (v, 32), dtype=bf), _randn(rng, (32,), 0.1) + 1.0,
            _randn(rng, (32,), 0.1), _randn(rng, (32, 32), 1 / np.sqrt(32)),
            _randn(rng, (32,), 0.1)]
    args = [a.requires_grad_() for a in args]
    ok = same_grads(ln_head, xla_ln_head, args)
    print(f"backward ln_head V={v} C=32->32: {'equal' if ok else 'DIFFERENT'}", flush=True)
    _need(ok, "ln_head backward differs from its composition")
    torch.cuda.empty_cache()


def _bench_train_cfg() -> dict:
    """The training cfg embedded in the bench checkpoint, on the defaults."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.config import cfg_from_dict

    return cfg_from_dict(load_checkpoint(os.path.join(ROOT, "runs", "bench_ckpt.skoots"))["cfg"])


def check_grads_against_cpu() -> None:
    """One f32 train step of the bench model at full width (dims
    32-64-128, depth 2, 7^3) on one seeded 32x32x16 batch, on the card and
    on the CPU (every kernel's plain version) from the same initial
    weights: loss within 1e-4 relative, every gradient present, finite and
    within 1e-3 * max|g_cpu|. TF32 is off for the comparison."""
    import torch

    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.utils.synthetic import make_tubes

    cfg = _bench_train_cfg()
    cfg["MODEL"]["DTYPE"] = "float32"
    shape = (32, 32, 16)
    img, labels, skels = make_tubes(shape=shape, n_tubes=3, radius=3, seed=3)
    packed = pack_skeletons(skels)
    batch = {
        "image": torch.from_numpy((img.astype(np.float32) - 41.8) / 20.4)[None, ..., None],
        "masks": torch.from_numpy((labels > 0).astype(np.float32))[None, ..., None],
        "baked": bake_skeleton(torch.from_numpy(labels), packed,
                               tuple(cfg["AUGMENTATION"]["BAKE_SKELETON_ANISOTROPY"]))[None],
        "skele_masks": skeleton_to_mask(packed, shape, 3, 3)[None, ..., None],
    }
    runs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (torch.device("cuda"), torch.device("cpu")):
            model = init_model(cfg, SEED, device=dev).train()
            opt, sched = cfg_optimizer(cfg, model.parameters())
            step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
            total, _ = step.loss_fn({k: v.to(dev) for k, v in batch.items()}, 0)
            total.backward()
            runs.append((float(total.detach()), {n: (None if p.grad is None else p.grad.cpu())
                                        for n, p in model.named_parameters()}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (l_card, g_card), (l_cpu, g_cpu) = runs
    worst, worst_name = 0.0, ""
    for name, gc in g_cpu.items():
        gd = g_card[name]
        _need(gd is not None and gc is not None, f"{name}: no gradient")
        _need(bool(torch.isfinite(gd).all()), f"{name}: gradient not finite on the card")
        rel = float((gd - gc).abs().max()) / max(float(gc.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"grads card vs cpu (f32, {shape}): loss {l_card:.8g} vs {l_cpu:.8g} "
          f"(rel {abs(l_card - l_cpu) / abs(l_cpu):.3g}, bound 1e-4); "
          f"{len(g_cpu)} gradients, worst {worst:.3g} of max|g_cpu| at {worst_name} "
          f"(bound 1e-3)", flush=True)
    _need(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu), "card and CPU losses differ")
    _need(worst <= 1e-3, f"gradient {worst_name} differs between card and CPU")


def run_train_slice(results: list) -> list:
    """The training path at the bench checkpoint's training cfg (bf16, crop
    96x96x32, batch 1) on two seeded 256x256x32 tube volumes with 8 tubes
    each, held in memory as ``VolumeRecord`` objects. Returns the volumes'
    (image, labels)."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.train.data import (
        SkootsDataset,
        VolumeRecord,
        batch_iterator,
        prefetch_iterator,
    )
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step, train
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.train.transforms import make_batch_augment
    from skoots_tpu_torch.utils.synthetic import make_tubes

    dev = torch.device("cuda")
    cfg = _bench_train_cfg()
    t = cfg["TRAIN"]
    t["NUM_EPOCHS"] = 2
    t["SAVE_INTERVAL"] = 2
    t["SAVE_PATH"] = os.path.join(ROOT, "build", "train_smoke")
    seed = t["SEED"]
    t0 = time.time()
    records = []
    for i in range(2):
        img, labels, skels = make_tubes(shape=(256, 256, 32), n_tubes=8, radius=5, seed=i)
        records.append(VolumeRecord(img.astype(np.float32), labels, skels, f"tubes{i}"))
    dataset = SkootsDataset(records, cfg, sample_per_image=8)
    mean, std = dataset.mean_std(with_invert=cfg["AUGMENTATION"]["INVERT_RATE"] > 0)
    radius = dataset.object_radius()
    augment = make_batch_augment(cfg, mean, std, dataset.intensity_ceiling(), device=dev)
    bsz = t["TRAIN_BATCH_SIZE"]
    host = batch_iterator(dataset, bsz, 8, seed)
    print(f"train setup: {time.time() - t0:.2f} s (2 volumes (256, 256, 32), "
          f"mean {mean:.4f} std {std:.4f}, object radius {radius})", flush=True)

    # 8 steps on one augmented batch, from a seeded fresh init
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed, device=dev).train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
    gen = torch.Generator().manual_seed(seed)
    host_batches = list(host(0))
    fixed = augment(host_batches[0], gen)
    losses, splits = [], []
    for i in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        augment(host_batches[i], gen)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total, metrics = step.loss_fn(fixed, 0)
        ev[2].record()
        total.backward()
        ev[3].record()
        step.apply_update(0)
        ev[4].record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    with torch.no_grad():
        final = float(step.loss_fn(fixed, 0)[0])
    peak = torch.cuda.max_memory_allocated()
    warm = np.median(np.asarray(splits[1:]), axis=0)
    print(f"train losses over 8 steps on one batch: {[round(v, 6) for v in losses]}, "
          f"after step 8: {final:.6f}", flush=True)
    print(f"train step split (warm median of 7, ms): augment {warm[0]:.3f} "
          f"forward+loss {warm[1]:.3f} backward {warm[2]:.3f} optimizer {warm[3]:.3f} "
          f"step {warm[1:].sum():.3f}", flush=True)
    print(f"train peak_device_memory_bytes {peak}", flush=True)
    _need(all(np.isfinite(losses)) and final < losses[0],
          f"the loss did not fall over 8 steps: {losses[0]} -> {final}")
    del model, opt, step, fixed

    # train() for 2 epochs of 8 steps through the whole augmentation
    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head,
               "upsample2x": upsample2x, "bake_skeleton": bake_skeleton_kernel}
    host_pf = prefetch_iterator(host)

    def data_iter(epoch: int):
        g = torch.Generator().manual_seed(seed + epoch)
        for host_batch in host_pf(epoch):
            yield augment(host_batch, g)

    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    state = train(cfg, data_iter, dev, dataset_mean=mean, dataset_std=std,
                  object_radius=radius)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    n = state.step
    # per step: 11 depthwise convs forward (stem + 10 blocks) and 10 input
    # gradients (not the stem's), 11 weight gradients, 10 block tails,
    # 1 LN head, 2 upsamples (the backward is the plain cascade's vjp), one
    # bake per sample
    per_step = {"dwconv3d": 21, "dwconv3d_wgrad": 11, "mlp_block_tail": 10,
                "ln_head": 1, "upsample2x": 2, "bake_skeleton": bsz}
    print(f"train(): {n} steps in {wall:.3f} s, last epoch means "
          f"{json.dumps(state.epoch_means)}", flush=True)
    print(f"train launches {json.dumps(counts)} expected per step "
          f"{json.dumps(per_step)}", flush=True)
    for name, c in counts.items():
        _need(c > 0, f"kernel {name} was not launched by train()")
        _need(c == n * per_step[name], f"{name}: {c} launches, expected {n * per_step[name]}")
    for r in results:
        r["launches"] += counts.get(r["name"], 0)

    ckpt = load_checkpoint(state.save_name)
    loaded = model_from_checkpoint(ckpt, device=dev)
    x = augment(host_batches[1], gen)["image"]
    with torch.no_grad():
        same = torch.equal(state.model.eval()(x), loaded(x))
    print(f"checkpoint {os.path.basename(state.save_name)}: epoch "
          f"{ckpt['extra']['epoch']}, reloaded forward "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    _need(same, "the reloaded checkpoint's forward differs from the trained model's")
    return [(r.image, r.masks) for r in records]


def check_yaml_reader() -> None:
    """``config.load_cfg_from_file`` on the bench checkpoint's training cfg
    with PyYAML blocked (the port's own YAML reader): it merges, validates,
    and agrees with the cfg the checkpoint embeds on every key of the
    file."""
    import importlib.util

    from skoots_tpu_torch.config import load_cfg_from_file, load_yaml, to_plain

    path = os.path.join(ROOT, "runs", "bench_ckpt_train", "cfg.yaml")
    installed = importlib.util.find_spec("yaml") is not None
    blocked = sys.modules.get("yaml", False)
    sys.modules["yaml"] = None  # any import of PyYAML now raises
    try:
        cfg = load_cfg_from_file(path)
        with open(path) as f:
            keys = [(sec, k) for sec, d in load_yaml(f.read()).items() for k in d]
    finally:
        if blocked is False:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = blocked
    ckpt_cfg = _bench_train_cfg()
    differ = [f"{s}.{k}" for s, k in keys if to_plain(cfg[s][k]) != to_plain(ckpt_cfg[s][k])]
    print(f"yaml reader: {os.path.relpath(path, ROOT)} merged and validated with PyYAML "
          f"blocked (installed on this machine: {installed}): {len(keys)} keys, MODEL.DIMS "
          f"{cfg['MODEL']['DIMS']}, TRAIN.SIGMA_DECAY {cfg['TRAIN']['SIGMA_DECAY']}; keys "
          f"differing from the checkpoint's cfg: {differ}", flush=True)
    _need(not differ and len(keys) > 10, f"the YAML reader's cfg differs at {differ}")


def run_experimental(results: list, vol, n_default: int, n_expected: int) -> None:
    """``skoots-torch --experimental`` (``cli.main``) with the bench
    checkpoint on the 256^3 host phantom as ``.npy``: the knobs the tuned
    eval passed to ``run_inference``, launch counts set to 0 just before
    and read just after (every forward kernel per forward, propagate per CC
    round, its plain version may not run), the instance count beside the
    default run's."""
    import shutil

    import torch

    from skoots_tpu_torch import cli
    from skoots_tpu_torch.experimental import eval as experimental_eval
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.kernels import propagate as prop_mod

    work = os.path.join(ROOT, "build", "experimental_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol)
    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    seen = {}
    real = experimental_eval.run_inference

    def recording(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    kernels = _launch_counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    saved = prop_mod.propagate_ref, experimental_eval.run_inference
    prop_mod.propagate_ref, experimental_eval.run_inference = _no_plain_propagation, recording
    try:
        t0 = time.time()
        rc = cli.main(["--image", path, "--pretrained-checkpoint", ckpt, "--log", "1",
                       "--experimental"])
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        prop_mod.propagate_ref, experimental_eval.run_inference = saved
    counts = {name: fn.launches for name, fn in kernels.items()}
    stats = json.loads(json.dumps(engine.last_stats))
    mask = np.load(os.path.join(work, "phantom_instance_mask.npy"))
    n = len(np.unique(mask)) - 1
    knobs = {k: seen.get(k) for k in ("prob_threshold", "dilation_3d", "dilation_2d",
                                      "embed_iterations", "embed_decay")}
    print(f"--experimental: rc {rc}, {n} instances (default knobs: {n_default}; "
          f"{n_expected} tubes placed) in {wall:.3f} s, knobs in effect {json.dumps(knobs)}, "
          f"engine {stats['engine']}", flush=True)
    print(f"--experimental launches: {json.dumps(counts)}", flush=True)
    _need(rc == 0 and n >= 1, f"--experimental: rc {rc}, {n} instances")
    _need(knobs == {"prob_threshold": 0.5, "dilation_3d": 0, "dilation_2d": 3,
                    "embed_iterations": 10, "embed_decay": 0.95},
          f"--experimental ran with {knobs}")
    forwards = stats["phase1"]["tiles"] + (stats["phase3"]["tiles"]
                                           if stats["wire_mode"] == "recompute" else 0)
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == k * forwards,
              f"--experimental {name}: {counts[name]} launches, expected {k} x {forwards}")
    _need(counts["propagate"] == stats["phase2"]["cc_rounds"] > 0,
          f"--experimental propagate: {counts['propagate']} launches against "
          f"{stats['phase2']['cc_rounds']} CC rounds")
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def run_skeletonize(volumes) -> list:
    """``train.generate_skeletons.calculate_skeletons(method="lee")`` (the
    host C++ Lee thinning, built at first use) on the training phase's
    seeded tube ``volumes`` (image, labels): every instance gets a point
    and at least 95% of the points lie in their own instance. Returns
    (image, labels, skeletons) per volume."""
    from skoots_tpu_torch.train.generate_skeletons import calculate_skeletons

    vols = []
    for i, (img, labels) in enumerate(volumes):
        t0 = time.time()
        skels = calculate_skeletons(labels, method="lee")
        dt = time.time() - t0
        ids = [int(k) for k in np.unique(labels) if k]
        own = total = 0
        for k, pts in skels.items():
            ii = np.clip(np.round(pts).astype(int), 0, np.asarray(labels.shape) - 1)
            own += int((labels[ii[:, 0], ii[:, 1], ii[:, 2]] == k).sum())
            total += len(pts)
        print(f"skeletonize (lee) volume {i} {labels.shape}: {dt:.3f} s (host; the first "
              f"call builds the library), {len(skels)} of {len(ids)} instances, "
              f"{total} points, {own / max(total, 1):.4f} inside their own instance",
              flush=True)
        _need(sorted(skels) == ids and all(len(v) >= 1 for v in skels.values()),
              f"skeletonize: instances {ids}, skeletons {sorted(skels)}")
        _need(own >= 0.95 * total, f"skeletonize: {own} of {total} points in their instance")
        vols.append((img, labels, skels))
    return vols


def run_sparse_train(results: list, vols) -> str:
    """Sparse training at the bench checkpoint's training cfg (bf16, crop
    96x96x32, batch 1, ``IS_SPARSE``) on in-memory ``SparseRecord``s of
    ``vols`` (background: more than ``SPARSE_BG_DIST`` voxels from a tube;
    the Lee skeletons as the annotation): 8 steps on one augmented batch
    for the step split, then ``train_sparse`` for 2 epochs of
    ``SPARSE_STEPS`` with the launch counts set to 0 before and read after
    (exact: per step and per calibrator forward), every loss finite, the
    checkpoint reloaded. Returns the checkpoint's path."""
    import logging

    import torch
    from scipy import ndimage

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.experimental.data import SparseDataset, SparseRecord
    from skoots_tpu_torch.experimental.sparse_engine import (
        make_sparse_augment,
        make_sparse_train_step,
        train_sparse,
    )
    from skoots_tpu_torch.experimental.sparse_loss import sparse_loss, vector_direction_penalty
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
    from skoots_tpu_torch.train.data import batch_iterator
    from skoots_tpu_torch.train.engine import cfg_optimizer
    from skoots_tpu_torch.train.sigma import init_sigma

    dev = torch.device("cuda")
    cfg = _bench_train_cfg()
    t = cfg["TRAIN"]
    t["NUM_EPOCHS"], t["SAVE_INTERVAL"] = 2, 2
    t["SAVE_PATH"] = os.path.join(ROOT, "build", "sparse_smoke")
    cfg["EXPERIMENTAL"]["IS_SPARSE"] = True
    seed = t["SEED"]
    records = [SparseRecord(img.astype(np.float32),
                            (ndimage.distance_transform_edt(labels == 0) > SPARSE_BG_DIST)
                            .astype(np.float32), None, skels, f"tubes{i}")
               for i, (img, labels, skels) in enumerate(vols)]

    # 8 steps on one augmented batch, split with CUDA events
    dataset = SparseDataset(records, cfg, sample_per_image=t["TRAIN_SAMPLE_PER_IMAGE"][0])
    mean = float(np.mean([r.image.mean() for r in dataset.records]))
    std = float(np.mean([r.image.std() for r in dataset.records]))
    augment = make_sparse_augment(cfg, mean, std, dev)
    host_batches = list(batch_iterator(dataset, t["TRAIN_BATCH_SIZE"], 8, seed)(0))
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed, device=dev).train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_sparse_train_step(model, opt, sched, init_sigma(cfg), cfg)
    fixed = augment(host_batches[0], gen)
    losses, splits = [], []
    for i in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        augment(host_batches[i], gen)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total, metrics = step.loss_fn(fixed, 0)
        ev[2].record()
        total.backward()
        ev[3].record()
        step.apply_update(0)
        ev[4].record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    peak = torch.cuda.max_memory_allocated()
    warm = np.median(np.asarray(splits[1:]), axis=0)
    print(f"sparse train losses over 8 steps on one batch: "
          f"{[round(v, 6) for v in losses]}", flush=True)
    print(f"sparse train step split (warm median of 7, ms): augment {warm[0]:.3f} "
          f"forward+loss {warm[1]:.3f} backward {warm[2]:.3f} optimizer {warm[3]:.3f} "
          f"step {warm[1:].sum():.3f}; peak_device_memory_bytes {peak}", flush=True)
    _need(all(np.isfinite(losses)), f"a sparse loss is not finite: {losses}")

    # the step's parts: the model's forward, the sparse loss (its bake and
    # loop included) and its direction penalty, each forward and backward
    scale = torch.tensor(cfg["SKOOTS"]["VECTOR_SCALING"], dtype=torch.float32, device=dev)
    with torch.no_grad():
        out = model(fixed["image"])
    vec = out[..., 0:3].float().requires_grad_()
    sem = out[..., 4:5].float().requires_grad_()

    def loss_of(v, s_):
        return sum(sparse_loss(vector_to_embedding(tuple(scale.tolist()), v), v * scale,
                               fixed["points"], fixed["valid"], fixed["background"], s_,
                               init_sigma(cfg)(0), tuple(cfg["AUGMENTATION"][
                                   "BAKE_SKELETON_ANISOTROPY"]),
                               float(cfg["EXPERIMENTAL"]["DIST_THR"]),
                               float(cfg["EXPERIMENTAL"]["SPARSE_BACKGROUND_PENALTY_MULTIPLIER"])
                               )[:2])

    def backward_ms(fn):
        return _time_ms(lambda: torch.autograd.grad(fn(), fn.inputs)) - _time_ms(fn)

    parts = {}
    with torch.no_grad():
        parts["model forward"] = _time_ms(lambda: model(fixed["image"]))
    loss_fn = lambda: loss_of(vec, sem)  # noqa: E731
    loss_fn.inputs = (vec, sem)
    pen_fn = lambda: vector_direction_penalty(vec * scale).mean()  # noqa: E731
    pen_fn.inputs = (vec,)
    parts["sparse loss forward"] = _time_ms(loss_fn)
    parts["sparse loss backward"] = backward_ms(loss_fn)
    parts["direction penalty forward"] = _time_ms(pen_fn)
    parts["direction penalty backward"] = backward_ms(pen_fn)
    print(f"sparse step parts (median of {REPEATS}, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}", flush=True)
    del model, opt, step, fixed, out, vec, sem

    # train_sparse: 2 epochs of SPARSE_STEPS, every launch counted
    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head,
               "upsample2x": upsample2x, "bake_skeleton": bake_skeleton_kernel}
    epochs = []

    class _Epochs(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("sparse epoch"):
                epochs.append(record.args[1])

    handler = _Epochs()
    sparse_log = logging.getLogger("skoots_tpu_torch.experimental.sparse_engine")
    sparse_log.addHandler(handler)
    level = sparse_log.level
    sparse_log.setLevel(logging.INFO)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    try:
        t0 = time.time()
        state = train_sparse(cfg, steps_per_epoch=SPARSE_STEPS, device=dev, records=records)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        sparse_log.removeHandler(handler)
        sparse_log.setLevel(level)
    counts = {name: fn.launches for name, fn in kernels.items()}
    n, fwd = state.step, state.calibration_forwards
    per_step = {"dwconv3d": 21, "dwconv3d_wgrad": 11, "mlp_block_tail": 10, "ln_head": 1,
                "upsample2x": 2, "bake_skeleton": t["TRAIN_BATCH_SIZE"]}
    per_forward = {**{k: 0 for k in per_step}, **FORWARD_KERNELS_PER_TILE}
    print(f"train_sparse: {n} steps and {fwd} calibrator forwards in {wall:.3f} s, epoch "
          f"means {json.dumps(epochs)}", flush=True)
    print(f"train_sparse launches {json.dumps(counts)} expected {n} x "
          f"{json.dumps(per_step)} + {fwd} x {json.dumps(per_forward)}", flush=True)
    _need(len(epochs) == 2 and all(np.isfinite(e["loss"]) and e["skipped"] == 0
                                   for e in epochs), f"sparse epochs {epochs}")
    _need(n == 2 * SPARSE_STEPS and fwd >= 1, f"train_sparse ran {n} steps, {fwd} forwards")
    for name, c in counts.items():
        want = n * per_step[name] + fwd * per_forward[name]
        _need(c == want, f"train_sparse {name}: {c} launches, expected {want}")
    for r in results:
        r["launches"] += counts.get(r["name"], 0)

    ckpt = load_checkpoint(state.save_name)
    extra = ckpt["extra"]
    loaded = model_from_checkpoint(ckpt, device=dev)
    x = augment(host_batches[1], gen)["image"]
    with torch.no_grad():
        same = torch.equal(state.saved_model.eval()(x), loaded(x))
    print(f"sparse checkpoint {os.path.basename(state.save_name)}: extra {json.dumps(extra)}, "
          f"reloaded forward {'equal' if same else 'DIFFERENT'}", flush=True)
    _need(same, "the reloaded sparse checkpoint's forward differs")
    _need(extra["calibrated_prob_threshold"] is not None and extra["swa"] is True,
          f"sparse checkpoint extra {extra}")
    torch.cuda.empty_cache()
    return state.save_name


def run_sparse_inference(results: list, ckpt_path: str, vol) -> None:
    """``run_inference`` with the sparse checkpoint on the ``SPARSE_BLOCK``
    block of the host phantom (``.npy`` in and out), launch counts set to 0
    just before and read just after; prints which semantic gate won, as the
    engine logs it."""
    import logging
    import shutil

    import torch

    from skoots_tpu_torch.infer import engine

    work = os.path.join(ROOT, "build", "sparse_smoke", "infer")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "block.npy")
    np.save(path, np.ascontiguousarray(vol[SPARSE_BLOCK]))
    gates = []

    class _Gate(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("semantic gate"):
                gates.append(record.getMessage())

    handler = _Gate()
    engine_log = logging.getLogger(engine.__name__)
    engine_log.addHandler(handler)
    level = engine_log.level
    engine_log.setLevel(logging.INFO)
    kernels = _launch_counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    try:
        t0 = time.time()
        mask = engine.run_inference(path, ckpt_path, output_path=os.path.join(work, "m.npy"))
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        engine_log.removeHandler(handler)
        engine_log.setLevel(level)
    counts = {name: fn.launches for name, fn in kernels.items()}
    source = ("probe" if any("volume-calibrated" in g for g in gates) else
              "calibrated" if any("checkpoint-calibrated" in g for g in gates) else "default")
    n = len(np.unique(np.asarray(mask))) - 1
    print(f"sparse checkpoint inference on a {tuple(mask.shape)} block: semantic gate from "
          f"the {source} ({gates}), {n} instances, {wall:.3f} s, launches "
          f"{json.dumps(counts)}", flush=True)
    forwards = counts["dwconv3d"] // FORWARD_KERNELS_PER_TILE["dwconv3d"]
    _need(len(gates) == 1 and forwards >= 1
          and all(counts[k] == v * forwards for k, v in FORWARD_KERNELS_PER_TILE.items()),
          f"sparse inference: gates {gates}, launches {counts}")
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    shutil.rmtree(os.path.join(ROOT, "build", "sparse_smoke"), ignore_errors=True)
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    print(gpu_line(), flush=True)
    _need(torch.cuda.is_available(), "no CUDA device: chip_smoke needs a GPU")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    import skoots_tpu_torch
    from skoots_tpu_torch.kernels import _build

    _need(os.path.dirname(os.path.dirname(os.path.abspath(
        skoots_tpu_torch.__file__))) == ROOT,
        f"skoots_tpu_torch must come from this checkout, not "
        f"{skoots_tpu_torch.__file__}")

    t0 = time.time()
    _build.library()
    print(f"build: {time.time() - t0:.1f} s -> {_build.library_path()}", flush=True)
    print(f"tensor-core instructions (cuobjdump -sass): "
          f"{json.dumps(tensor_core_sass(_build.library_path()))}", flush=True)

    check_yaml_reader()
    results = check_kernels()
    check_microbenchmarks(results)
    check_train_kernels(results)
    host_phantom, n_default, n_expected = run_host_engine(results)
    run_experimental(results, host_phantom, n_default, n_expected)
    ckpt, model, volume, chunked, chunked_peak, chunked_run = run_slice(results)
    check_against_cpu(ckpt, model, volume)
    torch.cuda.empty_cache()
    vol_u8, tile_bytes = run_thrifty(results, ckpt, model, volume, chunked, chunked_peak,
                                     chunked_run)
    check_sparse_probe(results, ckpt, model, volume)
    del ckpt, model, volume, chunked, chunked_run
    torch.cuda.empty_cache()
    run_thrifty_engine(results, vol_u8, tile_bytes)
    del vol_u8
    torch.cuda.empty_cache()
    check_grads_against_cpu()
    train_volumes = run_train_slice(results)
    sparse_ckpt = run_sparse_train(results, run_skeletonize(train_volumes))
    run_sparse_inference(results, sparse_ckpt, host_phantom)
    for r in results:
        r.pop("_largest")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
