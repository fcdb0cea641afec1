"""Drive the PyTorch/CUDA port (``skoots_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc``; exits non-zero (printing no result) without
them. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skoots_tpu_torch/csrc``;
3. compares every kernel with its plain PyTorch version on the card, at the
   shapes the main path gives it, on seeded random inputs, and times both
   with CUDA events (median of several runs);
4. runs the main path -- ``infer.device_pipeline.make_chunked_pipeline`` on
   the bench checkpoint ``runs/bench_ckpt.skoots`` at its full width, over
   the seeded tube phantom rendered on the card, with ``bench.py``'s knobs --
   with every kernel's launch count set to 0 just before and read just after;
5. prints the phase split, the instance count against the number of placed
   tubes, the CC rounds, the launch counts and peak device memory;
6. runs the same pipeline on a 128x128x64 block of the phantom on the card
   and on the CPU (every kernel's plain version) and compares the instances;
7. prints one JSON line of per-kernel results, and last the
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
REPEATS = 5


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


def check_kernels() -> list:
    """Kernel vs plain version on the card at the main-path shapes."""
    import torch

    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref
    from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_ref
    from skoots_tpu_torch.kernels.mlp import (
        mlp_block_tail,
        mlp_block_tail_ref,
    )
    from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref

    rng = np.random.default_rng(SEED)
    bf = torch.bfloat16
    tx, ty, tz = TILE
    results = []

    def record(name, source, replaces, err, err_abs, bound, unit, ms, plain_ms):
        ok = err <= bound
        print(f"kernel {name}: max err {err:.6g} {unit} (bound {bound:g}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        _need(ok, f"{name}: error {err} {unit} above bound {bound}")
        for r in results:
            if r["name"] == name:
                r["max_abs_err"] = max(r["max_abs_err"], err_abs)
                r["ms"] += ms
                r["plain_ms"] += plain_ms
                return
        results.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms})

    # 1. depthwise 7^3 conv: stem (1 -> 32, channel stride 0), then the
    #    three block widths at their resolutions; bound 1 bf16 ulp
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
        record("dwconv3d", "skoots_tpu_torch/csrc/dwconv.cu",
               "skoots_tpu/kernels/dwconv.py:334", bf16_ulps(got, ref), err_abs, 1.0,
               f"bf16 ulp at {tuple(x.shape)}->{c}",
               _time_ms(lambda: dwconv3d(x, w, b)),
               _time_ms(lambda: dwconv3d_ref(x, w, b)))
        del x, got, ref

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
        record("mlp_block_tail", "skoots_tpu_torch/csrc/mlp.cu",
               "skoots_tpu/kernels/mlp.py:99", excess, err_abs, 4e-3,
               f"(|d| - 1e-3|ref|) at V={v} C={c}",
               _time_ms(lambda: mlp_block_tail(*args)),
               _time_ms(lambda: mlp_block_tail_ref(*args)))
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
           _time_ms(lambda: ln_head_ref(x, ls, lb, w, b)))
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
    record("propagate", "skoots_tpu_torch/csrc/propagate.cu",
           "skoots_tpu/kernels/propagate.py:93", err_abs, err_abs, 0.0,
           f"voxels differing at {VOLUME} Q=4",
           _time_ms(lambda: propagate(lab, fg, passes=4)), _time_ms(plain4))
    del lab, fg, got, ref, idx
    torch.cuda.empty_cache()
    return results


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
               "ln_head": ln_head, "propagate": propagate}
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
    print(f"launches {json.dumps(counts)}", flush=True)
    print(f"peak_device_memory_bytes {peak}", flush=True)
    for r in results:
        r["launches"] = counts[r["name"]]
    for name, n in counts.items():
        _need(n > 0, f"kernel {name} was not launched on the main path")
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
    check_against_cpu(*run_slice(results))
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
