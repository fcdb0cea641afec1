"""The stem (the dense 1 -> C conv, ``csrc/dwconv.cu``) and its weight
gradient (``csrc/dwconv_wgrad.cu``) on the card, bf16, at the paths'
shapes (the bench model's 1 -> 32, the campaign model's 1 -> 16, the wide
model's 1 -> 48) and at k = 9 and 11; optionally the ``1-forward`` phase
of the bench and wide models on the 512^3 bench phantom.

    python -m skoots_tpu_torch.tools.bench_stems [--out FILE] [--repeats N]
        [--launches N] [--forward] [--forward-runs N]

Each case: the wrapper's time (CUDA events around ``--launches`` calls,
divided by them; the median of ``--repeats``) and its kernels' own device
time (``torch.profiler``), cuDNN's call for the same function
(``conv3d`` / ``conv3d_weight`` on the channels-last views), the least
time (``bench_train_kernels.bound``: the products on the tensor cores or
the bytes), the route the launch takes where the tree has the route query,
and a check against the plain version (forward within 1 bf16 ulp of
max(|plain|, rms(plain)), weight gradient within 1e-3 * max|plain| and the
same from run to run). With ``--forward``, ``tools/bench_tail_head.py::
forward_seconds`` for both models (``--forward-runs`` warm runs each).
Prints a JSON line a case and exits 1 if a check fails.

The file resolves ``skoots_tpu_torch`` from ``PYTHONPATH``, so one call can
time two trees on one card: ``PYTHONPATH=<tree> python <this file>`` for
each, each building its own kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from skoots_tpu_torch.kernels import dwconv as D
from skoots_tpu_torch.tools.bench_train_kernels import bound, device_ms, nbytes, wgrad_bound

# ([B, X, Y, Z], C, k, with the weight gradient): the bench model's stem at
# its tile and training crop, the campaign model's at its crop and two
# tiles, the wide model's at its two tiles and crop, then k = 9 and 11
CASES = (
    ((1, 256, 256, 96), 32, 7, False), ((1, 96, 96, 32), 32, 7, True),
    ((1, 96, 96, 32), 16, 7, True), ((1, 128, 128, 32), 16, 7, False),
    ((1, 192, 192, 32), 16, 7, False), ((1, 256, 256, 96), 48, 7, False),
    ((1, 256, 256, 64), 48, 7, False), ((1, 96, 96, 32), 48, 7, True),
    ((1, 96, 96, 32), 16, 9, True), ((1, 96, 96, 32), 16, 11, True),
    ((1, 96, 96, 32), 48, 9, True),
)


def events_ms(fn, repeats: int, launches: int) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``launches`` calls,
    divided by them, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def bf16_ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of max(|ref|, rms(ref))."""
    r = ref.float().abs()
    scale = torch.maximum(r, r.square().mean().sqrt())
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def stem_case(gen, shape, c, k, wgrad: bool, repeats: int, launches: int) -> dict:
    bf = torch.bfloat16
    x = torch.randn((*shape, 1), generator=gen, device="cuda").to(bf)
    w = (torch.randn((k, k, k, c), generator=gen, device="cuda") / k ** 1.5).to(bf).float()
    b = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(bf).float()
    xv, wl = x.permute(0, 4, 1, 2, 3), w.permute(3, 0, 1, 2).unsqueeze(1).to(bf).contiguous()
    got = D._dwconv3d_fwd(x, w, b)
    ulps = bf16_ulps(got, D.dwconv3d_ref(x, w, b))
    row = {"shape": list(shape), "c": c, "k": k,
           "route": D.dwconv3d_route(bf, 0, c, k) if hasattr(D, "dwconv3d_route") else None,
           "fwd_ms": events_ms(lambda: D._dwconv3d_fwd(x, w, b), repeats, launches),
           "fwd_device_ms": device_ms(lambda: D._dwconv3d_fwd(x, w, b)),
           "fwd_bound_ms": bound(nbytes(x, w, b, got), tensor_flops=2.0 * k ** 3 * got.numel()),
           "fwd_ulps": ulps, "ok": ulps <= 1.0}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        row["fwd_cudnn_ms"] = events_ms(lambda: F.conv3d(xv, wl, b.to(bf), padding=k // 2),
                                        repeats, max(1, launches // 4))
    del got
    if wgrad:
        g = (torch.randn((*shape, c), generator=gen, device="cuda") * 1e-3).to(bf)
        dw = D.dwconv3d_wgrad(x, g, k)
        ref = D.dwconv3d_wgrad_ref(x, g, k)
        err = float((dw - ref).abs().max()) / float(ref.abs().max())
        same = bool(torch.equal(dw, D.dwconv3d_wgrad(x, g, k)))
        gv = g.permute(0, 4, 1, 2, 3)
        row.update(
            wroute=(D.dwconv3d_wgrad_route(bf, 0, c, k)
                    if hasattr(D, "dwconv3d_wgrad_route") else None),
            wgrad_ms=events_ms(lambda: D.dwconv3d_wgrad(x, g, k), repeats, launches),
            wgrad_device_ms=device_ms(lambda: D.dwconv3d_wgrad(x, g, k)),
            wgrad_bound_ms=wgrad_bound(x, g, dw), wgrad_err=err, wgrad_repeats=same,
            ok=row["ok"] and err <= 1e-3 and same)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            row["wgrad_cudnn_ms"] = events_ms(lambda: torch.nn.grad.conv3d_weight(
                xv, (c, 1, k, k, k), gv, padding=k // 2), repeats, max(1, launches // 4))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--forward-runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stems: no CUDA device", file=sys.stderr)
        return 1
    import skoots_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {os.path.dirname(skoots_tpu_torch.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, c, k, wgrad in CASES:
        # a quarter of the launches at the 256^2 tiles (an older tree's FP32
        # kernel takes ~10 ms there)
        big = shape[1] * shape[2] * shape[3] > 4e6
        rows.append(stem_case(gen, shape, c, k, wgrad, args.repeats,
                              max(1, args.launches // 4) if big else args.launches))
        torch.cuda.empty_cache()
        print(json.dumps(rows[-1]), flush=True)
    forwards = []
    if args.forward:
        from skoots_tpu_torch.tools.bench_tail_head import forward_seconds

        forwards = [forward_seconds(False, args.forward_runs),
                    forward_seconds(True, args.forward_runs)]
        for f in forwards:
            print(json.dumps(f), flush=True)
    result = {"card": card, "tree": os.path.dirname(skoots_tpu_torch.__file__),
              "device": torch.cuda.get_device_name(0), "rows": rows, "forward": forwards}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
