"""Drive the PyTorch/CUDA port (``skoots_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc``; exits non-zero (printing no result) without
them. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skoots_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. compares every kernel with its plain PyTorch version on the card, at the
   shapes the main paths give it, on seeded random inputs, and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call, with CUDA events (median of several runs); checks
   that the block tail's and LN head's autograd backward is exactly the
   autograd of their plain compositions;
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
   just after; prints the phase split, the instance count against the
   number of placed tubes, the CC rounds, the launch counts and peak device
   memory;
7. runs the same pipeline on a 128x128x64 block of the phantom on the card
   and on the CPU and compares the instances;
8. one f32 train step of the full-width model on a 32x32x16 batch, on the
   card and on the CPU from the same weights: loss and every gradient;
9. training path (``skoots-train`` at the bench checkpoint's training cfg:
   bf16, crop 96x96x32, batch 1, on seeded synthetic tube volumes): 8 steps
   on one augmented batch (the loss must fall; the step time split into
   augment, forward + loss, backward and optimizer, and peak memory), then
   ``train.engine.train`` for 2 epochs of 8 steps through the whole
   augmentation with the launch counts set to 0 before and read after, and
   the saved checkpoint loaded back and run;
10. prints one JSON line of per-kernel results (each with its least time on
    the card, ``bound_ms``, from the bytes it must move at 3.35 TB/s and its
    operations at the published peak of their type), and last the
    ``{"ok": true, ...}`` device line.

Every phase raises on failure; nothing here catches it. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

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
# the upsample's inputs: the two decoder stages of the bench tile, of the
# host engine's 256x256x20 tile, and of the training crop at batch 2
UPSAMPLE_SHAPES = ((1, 64, 64, 24, 128), (1, 128, 128, 48, 64), (1, 64, 64, 5, 128),
                   (1, 128, 128, 10, 64), (2, 24, 24, 8, 128), (2, 48, 48, 16, 64))
REPEATS = 5
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# FP32 FLOP/s outside the tensor cores, dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12


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


def bound(moved: float, fp32_flops: float = 0.0, tensor_flops: float = 0.0):
    """(least ms, what bounds it): the larger of the bytes moved over the
    HBM rate and the operations over their type's peak (FP32 outside the
    tensor cores; bf16 matrix products on the tensor cores)."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (fp32_flops / FP32_FLOP_PER_S + tensor_flops / BF16_TENSOR_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _record(results, name, source, replaces, err, err_abs, tol, unit, ms,
            plain_ms, least, library_ms=None):
    """Print one kernel-vs-plain comparison, fail above ``tol``, and sum it
    into the kernel's entry of ``results`` (times and bounds add up over
    the shapes checked; ``bound_by`` is the largest shape's)."""
    ok = err <= tol
    lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
    print(f"kernel {name}: max err {err:.6g} {unit} (bound {tol:g}) "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms{lib} "
          f"least {least[0]:.4f} ms ({least[1]}) {'ok' if ok else 'FAIL'}", flush=True)
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
    from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_ref
    from skoots_tpu_torch.kernels.mlp import (
        mlp_block_tail,
        mlp_block_tail_ref,
    )
    from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref
    from skoots_tpu_torch.kernels.upsample import upsample2x, upsample2x_ref

    rng = np.random.default_rng(SEED)
    bf = torch.bfloat16
    tx, ty, tz = TILE
    results = []

    def record(*args, **kwargs):
        _record(results, *args, **kwargs)

    # 1. depthwise 7^3 conv: stem (1 -> 32, channel stride 0), then the
    #    three block widths at their resolutions; bound 1 bf16 ulp. Library
    #    call: cuDNN's bf16 conv3d on the channels-last view (grouped per
    #    channel; the stem a dense 1 -> 32 conv)
    for shape, cin in (((1, tx, ty, tz), 1), ((1, tx, ty, tz), 32),
                       ((1, tx // 2, ty // 2, tz // 2), 64),
                       ((1, tx // 4, ty // 4, tz // 4), 128)):
        c = max(cin, 32)
        x = _randn(rng, (*shape, cin), dtype=bf)
        w = _randn(rng, (7, 7, 7, c), 1 / np.sqrt(343)).to(bf).float()
        b = _randn(rng, (c,), 0.1).to(bf).float()
        got = dwconv3d(x, w, b)
        ref = dwconv3d_ref(x, w, b)
        torch.cuda.synchronize()
        err_abs = float((got.float() - ref.float()).abs().max())
        xv = x.permute(0, 4, 1, 2, 3)
        wl = w.permute(3, 0, 1, 2).unsqueeze(1).to(bf).contiguous()
        bl = b.to(bf)
        groups = 1 if cin == 1 else c
        record("dwconv3d", "skoots_tpu_torch/csrc/dwconv.cu",
               "skoots_tpu/kernels/dwconv.py:334", bf16_ulps(got, ref), err_abs, 1.0,
               f"bf16 ulp at {tuple(x.shape)}->{c}",
               _time_ms(lambda: dwconv3d(x, w, b)),
               _time_ms(lambda: dwconv3d_ref(x, w, b)),
               bound(nbytes(x, w, b, got), fp32_flops=2.0 * 343 * got.numel()),
               _time_ms(lambda: F.conv3d(xv, wl, bl, padding=3, groups=groups)))
        del x, got, ref, xv

    # 2. fused block tail at the three widths (V = voxels of one tile at
    #    that resolution); bound atol 4e-3, rtol 1e-3
    for v, c in ((tx * ty * tz, 32), (tx * ty * tz // 8, 64),
                 (tx * ty * tz // 64, 128)):
        x = _randn(rng, (v, c), dtype=bf)
        s = _randn(rng, (v, c), 0.1, dtype=bf)
        ls = _randn(rng, (c,), 0.1) + 1.0
        lb = _randn(rng, (c,), 0.1)
        w1 = _randn(rng, (c, 4 * c), 1 / np.sqrt(c), dtype=bf)
        b1 = _randn(rng, (4 * c,), 0.1)
        w2 = _randn(rng, (4 * c, c), 1 / np.sqrt(4 * c), dtype=bf)
        b2 = _randn(rng, (c,), 0.1)
        g = torch.full((c,), 0.1, device="cuda")
        args = (x, s, ls, lb, w1, b1, w2, b2, g)
        got = mlp_block_tail(*args)
        ref = mlp_block_tail_ref(*args)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err_abs = float(diff.max())
        excess = float((diff - 1e-3 * ref.float().abs()).max())
        # least time: the bytes, or the two bf16 matrix products on the
        # tensor cores (LayerNorm and GELU not counted)
        record("mlp_block_tail", "skoots_tpu_torch/csrc/mlp.cu",
               "skoots_tpu/kernels/mlp.py:99", excess, err_abs, 4e-3,
               f"(|d| - 1e-3|ref|) at V={v} C={c}",
               _time_ms(lambda: mlp_block_tail(*args)),
               _time_ms(lambda: mlp_block_tail_ref(*args)),
               bound(nbytes(*args, got), tensor_flops=16.0 * v * c * c))
        del args, x, s, got, ref, diff

    # 3. fused final LN + 32 -> 32 head over one full-resolution tile;
    #    bound 1 bf16 ulp
    v = tx * ty * tz
    x = _randn(rng, (v, 32), dtype=bf)
    ls = _randn(rng, (32,), 0.1) + 1.0
    lb = _randn(rng, (32,), 0.1)
    w = _randn(rng, (32, 32), 1 / np.sqrt(32), dtype=bf)
    b = _randn(rng, (32,), 0.1)
    got = ln_head(x, ls, lb, w, b)
    ref = ln_head_ref(x, ls, lb, w, b)
    torch.cuda.synchronize()
    err_abs = float((got.float() - ref.float()).abs().max())
    record("ln_head", "skoots_tpu_torch/csrc/lnhead.cu",
           "skoots_tpu/kernels/lnhead.py:53",
           bf16_ulps(got, ref), err_abs, 1.0,
           f"bf16 ulp at V={v} C=32->32",
           _time_ms(lambda: ln_head(x, ls, lb, w, b)),
           _time_ms(lambda: ln_head_ref(x, ls, lb, w, b)),
           bound(nbytes(x, ls, lb, w, b, got), tensor_flops=2.0 * v * 32 * 32))
    del x, got, ref

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


def run_host_engine(results: list) -> None:
    """The host-streaming engine through ``run_inference`` at its defaults
    on a seeded 256^3 tube phantom (uint8 ``.npy``) with the bench
    checkpoint, then its ``--use-cached`` and out-of-core reruns, then a
    128x128x32 block on the card and on the CPU."""
    import shutil

    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.kernels.dwconv import dwconv3d
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
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

    kernels = {"dwconv3d": dwconv3d, "mlp_block_tail": mlp_block_tail,
               "ln_head": ln_head, "upsample2x": upsample2x,
               "propagate": prop_mod.propagate}
    per_forward = {"dwconv3d": 11, "mlp_block_tail": 10, "ln_head": 1, "upsample2x": 2}

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
    n = len(np.unique(mask)) - 1
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


def run_slice(results: list):
    """The main path on the bench checkpoint and phantom; returns
    ``(checkpoint, model, phantom)`` for :func:`check_against_cpu`."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.kernels.dwconv import dwconv3d
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.propagate import propagate
    from skoots_tpu_torch.kernels.upsample import upsample2x
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
    kernels = {"dwconv3d": dwconv3d, "mlp_block_tail": mlp_block_tail,
               "ln_head": ln_head, "upsample2x": upsample2x, "propagate": propagate}
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.time()
    inst = run(volume, mean, std)
    torch.cuda.synchronize()
    e2e = time.time() - t0
    counts = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    _need(tuple(inst.shape) == shape and inst.dtype == torch.int32,
          f"output {tuple(inst.shape)} {inst.dtype}")
    n_instances = int((torch.unique(inst) > 0).sum())
    print(f"phases: {json.dumps(run.last_phase_s)} e2e {e2e:.3f} s", flush=True)
    print(f"n_instances {n_instances} n_expected {n_expected}", flush=True)
    print(f"cc_rounds {run.last_cc_rounds} cc_converged {run.last_cc_converged}",
          flush=True)
    print(f"inference launches {json.dumps(counts)}", flush=True)
    print(f"peak_device_memory_bytes {peak}", flush=True)
    for r in results:
        r["launches"] += counts.get(r["name"], 0)
    for name, n in counts.items():
        _need(n > 0, f"kernel {name} was not launched on the main path")
    n_tiles = int(np.prod([-(-v // t) for v, t in zip(shape, TILE)]))
    _need(counts["upsample2x"] == 2 * n_tiles,
          f"upsample2x: {counts['upsample2x']} launches, expected 2 x {n_tiles} tiles")
    _need(0.8 * n_expected <= n_instances <= n_expected + 4,
          f"n_instances {n_instances} outside [0.8*{n_expected}, {n_expected}+4]")
    return ckpt, model, volume


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


def check_train_kernels(results: list) -> None:
    """The training path's kernels against their plain versions at its
    shapes (crop 96x96x32 and its two coarser levels), and the autograd
    wiring of the block tail and LN head."""
    import torch

    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad, dwconv3d_wgrad_ref
    from skoots_tpu_torch.kernels.lnhead import ln_head, xla_ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail, xla_tail

    rng = np.random.default_rng(SEED + 1)
    bf = torch.bfloat16
    cx, cy, cz = TRAIN_CROP

    # 1. depthwise weight gradient: the stem (1 -> 32, channel stride 0)
    #    and the three block widths at their levels; bound 1e-3 * max|plain|
    #    (f32 sums of the same bf16 products in another order)
    for (sx, sy, sz), cin, c in (((cx, cy, cz), 1, 32), ((cx, cy, cz), 32, 32),
                                 ((cx // 2, cy // 2, cz // 2), 64, 64),
                                 ((cx // 4, cy // 4, cz // 4), 128, 128)):
        x = _randn(rng, (1, sx, sy, sz, cin), dtype=bf)
        g = _randn(rng, (1, sx, sy, sz, c), 1e-3, dtype=bf)
        got = dwconv3d_wgrad(x, g, 7)
        ref = dwconv3d_wgrad_ref(x, g, 7)
        torch.cuda.synchronize()
        err_abs = float((got - ref).abs().max())
        # library call: cuDNN's bf16 weight gradient on the channels-last
        # views (grouped per channel; the stem's dense 1 -> 32)
        xv, gv = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        groups = 1 if cin == 1 else c
        _record(results, "dwconv3d_wgrad", "skoots_tpu_torch/csrc/dwconv_wgrad.cu",
                "skoots_tpu/kernels/dwconv.py:782", err_abs / float(ref.abs().max()),
                err_abs, 1e-3, f"of max|plain| at {(sx, sy, sz)} {cin}->{c}",
                _time_ms(lambda: dwconv3d_wgrad(x, g, 7)),
                _time_ms(lambda: dwconv3d_wgrad_ref(x, g, 7)),
                bound(nbytes(x, g, got), fp32_flops=2.0 * 343 * g.numel()),
                _time_ms(lambda: torch.nn.grad.conv3d_weight(
                    xv, (c, 1, 7, 7, 7), gv, padding=3, groups=groups)))
        del x, g, got, ref, xv, gv

    # 2. skeleton bake over one crop, anisotropy (1, 1, 3): 8 box
    #    instances, P points inside them; exact
    shape = (cx, cy, cz)
    masks = torch.zeros(shape, dtype=torch.int32)
    boxes = []
    for i in range(1, 9):
        lo = rng.integers(0, np.asarray(shape) // 2)
        hi = lo + rng.integers(4, np.asarray(shape) // 2)
        masks[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = i
        boxes.append((lo, hi))
    masks = masks.cuda()
    for p in (256, 4096):
        ids = rng.integers(1, 9, p).astype(np.int32)
        ids[-p // 16:] = 0  # padding
        lo = np.stack([boxes[i - 1][0] for i in np.maximum(ids, 1)])
        hi = np.stack([boxes[i - 1][1] for i in np.maximum(ids, 1)])
        pts = (lo + rng.random((p, 3)) * (hi - lo)).astype(np.float32)
        pts_t = torch.from_numpy(pts).cuda()
        ids_t = torch.from_numpy(ids).cuda()
        got = bake_skeleton_kernel(masks, pts_t, ids_t, (1.0, 1.0, 3.0))
        ref = bake_skeleton_ref(masks, pts_t, ids_t, (1.0, 1.0, 3.0))
        torch.cuda.synchronize()
        diff = int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
        err_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        # the work this data needs: 11 FP32 operations for every voxel and
        # point of its own instance
        per_id = torch.bincount(ids_t[ids_t > 0].long(), minlength=9)
        pairs = float(torch.where(masks > 0, per_id[masks.long()], 0).sum())
        _record(results, "bake_skeleton", "skoots_tpu_torch/csrc/bake.cu",
                "skoots_tpu/kernels/bake.py:112", float(diff), err_abs, 0.0,
                f"values differing at V={masks.numel()} P={p}",
                _time_ms(lambda: bake_skeleton_kernel(masks, pts_t, ids_t, (1.0, 1.0, 3.0))),
                _time_ms(lambda: bake_skeleton_ref(masks, pts_t, ids_t, (1.0, 1.0, 3.0))),
                bound(nbytes(masks, pts_t, ids_t, *got), fp32_flops=11.0 * pairs))
        del got, ref

    # 3. autograd wiring: each wrapper's gradients are exactly the autograd
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


def run_train_slice(results: list) -> None:
    """The training path at the bench checkpoint's training cfg (bf16, crop
    96x96x32, batch 1) on two seeded 256x256x32 tube volumes with 8 tubes
    each, held in memory as ``VolumeRecord`` objects."""
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

    results = check_kernels()
    check_microbenchmarks(results)
    check_train_kernels(results)
    run_host_engine(results)
    check_against_cpu(*run_slice(results))
    torch.cuda.empty_cache()
    check_grads_against_cpu()
    run_train_slice(results)
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
