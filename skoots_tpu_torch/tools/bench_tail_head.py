"""The block tail (``csrc/mlp.cu``) and the LN head (``csrc/lnhead.cu``) on
the card at the bench model's, the wide model's and the odd widths' shapes,
and the ``1-forward`` phase of both models on the 512^3 bench phantom.

    python -m skoots_tpu_torch.tools.bench_tail_head [--out FILE] [--repeats N]
        [--no-forward]

Each case: the wrapper's time (median of ``--repeats`` CUDA-event runs
of one call) and its kernels' own device time (``torch.profiler``), its
plain cuBLAS composition's two times (``xla_tail`` / ``xla_ln_head``), its
least time (the bytes at 3.35 TB/s, the products on the tensor cores at
bf16 or the FP32 pipe at f32, the tail's epilogue on the FP32 pipe), the
route the launch takes where the tree has the route query, and a check
against the plain version (the tail within its Pallas bound, the head
equal). Then, unless ``--no-forward``, ``make_chunked_pipeline`` at
``bench.py``'s knobs with the bench checkpoint and with the 1.5x-wide
UNeXT3D (``MODEL.DIMS`` 48-96-192-96-48, random weights from seed 0): one
warm-up run, then the median of three runs' ``1-forward``. Prints a line a
case and one JSON line; exits 1 if a check fails.

The file resolves ``skoots_tpu_torch`` from ``PYTHONPATH``, so one call can
time two trees on one card: ``PYTHONPATH=<tree> python
<this file> --out ...`` for each, each building its own kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_ref, xla_ln_head
from skoots_tpu_torch.kernels.mlp import mlp_block_tail, mlp_block_tail_ref, xla_tail
from skoots_tpu_torch.tools import median_ms
from skoots_tpu_torch.tools.bench_train_kernels import bound, device_ms, nbytes

# the block tail's work on the FP32 pipe, in instructions (issue slots of
# one lane): per hidden value the bias add, three roundings, an erf (about
# 9) and the GELU's 3 -- 16; per channel of the LayerNorm 8 (sum, centre,
# square and sum, scale, affine, round); per output value 7 (bias, layer
# scale and residual with their four roundings)
PER_HIDDEN, PER_LN, PER_OUT = 16, 8, 7
# (V, C, dtype): the bench model's levels, the wide model's, then the odd
# widths PR 14's run-time-width kernel served
TAIL_CASES = (
    (6291456, 32, "bf16"), (786432, 64, "bf16"), (98304, 128, "bf16"),
    (6291456, 48, "bf16"), (786432, 96, "bf16"), (98304, 192, "bf16"),
    (100003, 8, "bf16"), (30011, 24, "bf16"), (30011, 48, "bf16"), (7777, 96, "bf16"),
    (4099, 256, "bf16"), (4173, 16, "f32"), (4173, 24, "f32"), (4173, 256, "f32"))
# (V, C, N, dtype): the bench model's head, the wide model's, the odd ones
HEAD_CASES = (
    (6291456, 32, 32, "bf16"), (6291456, 48, 48, "bf16"),
    (100003, 8, 8, "bf16"), (30011, 24, 24, "bf16"), (30011, 48, 200, "bf16"),
    (4099, 256, 256, "bf16"), (4099, 32, 256, "bf16"), (12347, 16, 130, "bf16"),
    (4173, 16, 16, "f32"), (4173, 256, 256, "f32"))
WIDE_DIMS = [48, 96, 192, 96, 48]
VOLUME, TILE = (512, 512, 512), (256, 256, 96)


def tail_ops(v: int, c: int, dtn: str) -> dict:
    """The block tail's operations at ``v`` rows of ``c`` channels, by the
    pipe that runs them: the two products on the tensor cores at bf16 (on
    the FP32 pipe at f32), the LayerNorm, GELU and roundings on the FP32
    pipe (an instruction counts as 2 FLOP, as an FMA does)."""
    fp32 = 2.0 * v * c * (4 * PER_HIDDEN + PER_LN + PER_OUT)
    products = 16.0 * v * c * c
    return ({"tensor_flops": products, "fp32_flops": fp32} if dtn == "bf16"
            else {"fp32_flops": products + fp32})


def head_ops(v: int, c: int, n: int, dtn: str) -> dict:
    """The LN head's: ``c`` x ``n`` products a row on the tensor cores at
    bf16 (the FP32 pipe at f32), the LayerNorm on the FP32 pipe."""
    fp32 = 2.0 * v * c * PER_LN
    products = 2.0 * v * c * n
    return ({"tensor_flops": products, "fp32_flops": fp32} if dtn == "bf16"
            else {"fp32_flops": products + fp32})


def _route(module, name, *args):
    fn = getattr(module, name, None)
    return fn(*args) if fn is not None else "no route query"


def tail_case(gen, v, c, dtn, repeats):
    import skoots_tpu_torch.kernels.mlp as mlp

    dt = torch.bfloat16 if dtn == "bf16" else torch.float32

    def r(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    args = (r(v, c).to(dt), r(v, c, scale=0.1).to(dt), r(c, scale=0.1) + 1.0,
            r(c, scale=0.1), r(c, 4 * c, scale=c ** -0.5).to(dt), r(4 * c, scale=0.1),
            r(4 * c, c, scale=0.5 * c ** -0.5).to(dt), r(c, scale=0.1),
            torch.full((c,), 0.1, device="cuda"))
    got, ref = mlp_block_tail(*args), mlp_block_tail_ref(*args)
    excess = float(((got.float() - ref.float()).abs() - 1e-3 * ref.float().abs()).max())
    least = bound(nbytes(*args, got), **tail_ops(v, c, dtn))
    del ref
    return {"kernel": "mlp_block_tail", "V": v, "C": c, "dtype": dtn,
            "route": _route(mlp, "mlp_tail_route", dt, c), "ok": excess <= 4e-3,
            "ms": median_ms(lambda: mlp_block_tail(*args), repeats),
            "composition_ms": median_ms(lambda: xla_tail(*args), repeats),
            "device_ms": device_ms(lambda: mlp_block_tail(*args)),
            "composition_device_ms": device_ms(lambda: xla_tail(*args)),
            "bound_ms": least[0], "bound_by": least[1]}


def head_case(gen, v, c, n, dtn, repeats):
    import skoots_tpu_torch.kernels.lnhead as lnhead

    dt = torch.bfloat16 if dtn == "bf16" else torch.float32

    def r(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    args = (r(v, c).to(dt), r(c, scale=0.1) + 1.0, r(c, scale=0.1),
            r(c, n, scale=c ** -0.5).to(dt), r(n, scale=0.1))
    got = ln_head(*args)
    differing = int((got != ln_head_ref(*args)).sum())
    least = bound(nbytes(*args, got), **head_ops(v, c, n, dtn))
    return {"kernel": "ln_head", "V": v, "C": c, "N": n, "dtype": dtn,
            "route": _route(lnhead, "ln_head_route", dt, c, n), "ok": differing == 0,
            "ms": median_ms(lambda: ln_head(*args), repeats),
            "composition_ms": median_ms(lambda: xla_ln_head(*args), repeats),
            "device_ms": device_ms(lambda: ln_head(*args)),
            "composition_device_ms": device_ms(lambda: xla_ln_head(*args)),
            "bound_ms": least[0], "bound_by": least[1]}


def forward_seconds(wide: bool, repoll: int = 3, kernel_size: int | None = None) -> dict:
    """The ``1-forward`` phase of ``make_chunked_pipeline`` at ``bench.py``'s
    knobs on the 512^3 bench phantom (48 tubes, seed 7): the bench
    checkpoint's model, or its cfg at ``WIDE_DIMS`` (``wide``) or at
    ``MODEL.KERNEL_SIZE`` ``kernel_size`` with random weights from seed 0.
    The first run's, then the median of ``repoll`` more."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.config import cfg_from_dict
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    import skoots_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(skoots_tpu_torch.__file__)))
    ckpt = load_checkpoint(os.path.join(root, "runs", "bench_ckpt.skoots"))
    cfg = cfg_from_dict(ckpt["cfg"])
    if wide:
        cfg["MODEL"].update(DIMS=WIDE_DIMS, OUT_CHANNELS=WIDE_DIMS[-1])
    if kernel_size is not None:
        cfg["MODEL"]["KERNEL_SIZE"] = kernel_size
    if wide or kernel_size is not None:
        model = init_model(cfg, 0, device="cuda").eval()
    else:
        model = model_from_checkpoint(ckpt, device="cuda")
    p0, p1, _ = tube_segments(VOLUME, 48, radius=5.0, seed=7)
    volume = render_tubes(VOLUME, p0, p1, radius=5.0, device="cuda")
    run = make_chunked_pipeline(
        model, VOLUME, crop=TILE, overlap=(0, 0, 0), assign_crop=(256, 256, 64),
        vector_scale=tuple(cfg["SKOOTS"]["VECTOR_SCALING"]), embed_iterations=10,
        embed_exit_fraction=1e-3, embed_compact_div=16, cc_rounds=24,
        cc_propagates_per_round=192, cc_jumps_per_round=0, device="cuda")
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    with torch.no_grad():
        run(volume, mean, std)
        first = run.last_phase_s["1-forward"]
        fwd, e2e = [], []
        for _ in range(repoll):
            torch.cuda.synchronize()
            t0 = time.time()
            run(volume, mean, std)
            torch.cuda.synchronize()
            e2e.append(time.time() - t0)
            fwd.append(run.last_phase_s["1-forward"])
    del model, volume, run
    torch.cuda.empty_cache()
    name = "wide 48-96-192" if wide else "bench 32-64-128"
    return {"model": name if kernel_size is None else f"{name} k = {kernel_size}",
            "1-forward_first_s": first, "1-forward_s": float(np.median(fwd)),
            "1-forward_runs_s": fwd,
            "e2e_s": float(np.median(e2e))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_tail_head: no CUDA device", file=sys.stderr)
        return 1
    import skoots_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {os.path.dirname(skoots_tpu_torch.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case in TAIL_CASES:
        rows.append(tail_case(gen, *case, args.repeats))
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    for case in HEAD_CASES:
        rows.append(head_case(gen, *case, args.repeats))
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    forwards = [] if args.no_forward else [forward_seconds(False), forward_seconds(True)]
    for f in forwards:
        print(json.dumps(f), flush=True)
    result = {"card": card, "tree": os.path.dirname(skoots_tpu_torch.__file__),
              "device": torch.cuda.get_device_name(0), "rows": rows, "forward": forwards}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"ok": all(r["ok"] for r in rows)}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
