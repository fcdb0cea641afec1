"""The bf16 depthwise conv (``csrc/dwconv.cu``) and its weight gradient
(``csrc/dwconv_wgrad.cu``) on the card at k = 9, 11, 13, 15: the k = 9 and
k = 11 models' tile levels (C = 32 256^2 x 96, C = 64 128^2 x 48, C = 128
64^2 x 24; forward) and training-crop levels (C = 32 96^2 x 32, C = 64
48^2 x 16, C = 128 24^2 x 8; forward and weight gradient), and C = 16 at
96^2 x 32; optionally the ``1-forward`` phase of those models (and of the
bench model's cfg, k = 7) on the 512^3 bench phantom.

    python skoots_tpu_torch/tools/bench_bigk.py [--out FILE] [--ks 9,11,13,15]
        [--repeats N] [--budget-ms T] [--forward] [--forward-runs N]

Each case: the wrapper's time (CUDA events around as many calls as fit
``--budget-ms``, at least one and at most 20, divided by them; the median
of ``--repeats``), its kernels' own device time (``torch.profiler``),
cuDNN's call for the same function (``conv3d`` / ``conv3d_weight`` on the
channels-last views, grouped per channel), the least time
(``bench_train_kernels.bound``: the products on the tensor cores or the
bytes), the route the launch takes, and a check against the plain version
(forward within 1 bf16 ulp of max(|plain|, rms(plain)), weight gradient
within 1e-3 * max|plain| and the same from run to run). With ``--forward``,
``tools/bench_tail_head.py::forward_seconds`` for the bench checkpoint's
cfg at ``MODEL.KERNEL_SIZE`` 7, 9 and 11 (random weights from seed 0; the
first run's, then the median of ``--forward-runs`` more). Prints a JSON
line a case and exits 1 if a check fails.

``--ks 7`` times the same shapes on the k = 7 kernels (the bench model's
rows). The file resolves ``skoots_tpu_torch`` from ``PYTHONPATH``, so one
call can time two trees on one card: ``PYTHONPATH=<tree> python <this
file>`` for each, each building its own kernels and taking the timing
helpers of its own ``tools/bench_stems.py`` and ``tools/bench_tail_head.py``
(an older tree runs k >= 9 on its run-time-k kernels: keep ``--ks 9,11``
there, k = 15 takes ~1 s a call; a tree whose ``forward_seconds`` takes no
``kernel_size`` cannot run ``--forward``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from skoots_tpu_torch.kernels import dwconv as D
from skoots_tpu_torch.tools.bench_stems import bf16_ulps
from skoots_tpu_torch.tools.bench_stems import events_ms as stem_events_ms
from skoots_tpu_torch.tools.bench_tail_head import forward_seconds
from skoots_tpu_torch.tools.bench_train_kernels import bound, device_ms, nbytes, wgrad_bound

# ([B, X, Y, Z], C, with the weight gradient): the k-models' tile levels,
# their training crop's levels, and the 16-channel crop level
SHAPES = (
    ((1, 256, 256, 96), 32, False), ((1, 128, 128, 48), 64, False),
    ((1, 64, 64, 24), 128, False), ((1, 96, 96, 32), 32, True),
    ((1, 48, 48, 16), 64, True), ((1, 24, 24, 8), 128, True), ((1, 96, 96, 32), 16, True),
)


def events_ms(fn, repeats: int, budget_ms: float) -> float:
    """``bench_stems.events_ms`` around n calls, n as many as fit
    ``budget_ms`` by one timed call (1 to 20)."""
    n = int(max(1, min(20, budget_ms // max(stem_events_ms(fn, 1, 1), 1e-3))))
    return stem_events_ms(fn, repeats, n)


def case(gen, shape, c, k, wgrad: bool, repeats: int, budget_ms: float) -> dict:
    bf = torch.bfloat16
    x = torch.randn((*shape, c), generator=gen, device="cuda").to(bf)
    w = (torch.randn((k, k, k, c), generator=gen, device="cuda") / k ** 1.5).to(bf).float()
    b = (torch.randn(c, generator=gen, device="cuda") * 0.1).to(bf).float()
    xv, wl = x.permute(0, 4, 1, 2, 3), w.permute(3, 0, 1, 2).unsqueeze(1).to(bf).contiguous()
    got = D._dwconv3d_fwd(x, w, b)
    ulps = bf16_ulps(got, D.dwconv3d_ref(x, w, b))
    row = {"shape": list(shape), "c": c, "k": k, "route": D.dwconv3d_route(bf, 1, c, k),
           "fwd_ms": events_ms(lambda: D._dwconv3d_fwd(x, w, b), repeats, budget_ms),
           "fwd_device_ms": device_ms(lambda: D._dwconv3d_fwd(x, w, b)),
           "fwd_bound_ms": bound(nbytes(x, w, b, got), tensor_flops=2.0 * k ** 3 * got.numel()),
           "fwd_ulps": ulps, "ok": ulps <= 1.0}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        row["fwd_cudnn_ms"] = events_ms(
            lambda: F.conv3d(xv, wl, b.to(bf), padding=k // 2, groups=c), repeats, budget_ms)
    del got
    if wgrad:
        g = (torch.randn((*shape, c), generator=gen, device="cuda") * 1e-3).to(bf)
        dw = D.dwconv3d_wgrad(x, g, k)
        ref = D.dwconv3d_wgrad_ref(x, g, k)
        err = float((dw - ref).abs().max()) / float(ref.abs().max())
        same = bool(torch.equal(dw, D.dwconv3d_wgrad(x, g, k)))
        gv = g.permute(0, 4, 1, 2, 3)
        row.update(
            wroute=D.dwconv3d_wgrad_route(bf, 1, c, k),
            wgrad_ms=events_ms(lambda: D.dwconv3d_wgrad(x, g, k), repeats, budget_ms),
            wgrad_device_ms=device_ms(lambda: D.dwconv3d_wgrad(x, g, k)),
            wgrad_bound_ms=wgrad_bound(x, g, dw), wgrad_err=err, wgrad_repeats=same,
            ok=row["ok"] and err <= 1e-3 and same)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            row["wgrad_cudnn_ms"] = events_ms(lambda: torch.nn.grad.conv3d_weight(
                xv, (c, 1, k, k, k), gv, padding=k // 2, groups=c), repeats, budget_ms)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--ks", default="9,11,13,15")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--budget-ms", type=float, default=40.0)
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--forward-runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_bigk: no CUDA device", file=sys.stderr)
        return 1
    import skoots_tpu_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; tree {os.path.dirname(skoots_tpu_torch.__file__)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ks = [int(v) for v in args.ks.split(",")]
    rows = []
    for k in ks:
        for shape, c, wgrad in SHAPES:
            rows.append(case(gen, shape, c, k, wgrad, args.repeats, args.budget_ms))
            torch.cuda.empty_cache()
            print(json.dumps(rows[-1]), flush=True)
    forwards = []
    if args.forward:
        for k in (7, 9, 11):
            forwards.append(forward_seconds(False, args.forward_runs, kernel_size=k))
            print(json.dumps(forwards[-1]), flush=True)
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
