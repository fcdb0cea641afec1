"""Readings for the limits of ``correct``: the program's and the control's.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 1] [--out FILE]

Runs the cell's entry in this one process once a seed, with a short window,
and prints each run's compared numbers as a JSON line (and appends it to
``--out``): first the program on ``--seeds``, then the control (the fp8
reference in the program's place, ``reference/quant.py``) on
``--control-seeds``. The lower reading of a number is the largest the
program gives, the upper the smallest the control gives; a limit lies
between them. Needs the card; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.fixed_caches()
    import torch

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    workload = harness.load_json("workloads", args.workload)
    entry = harness.load_module("entries", workload["entry"])
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    # the reference switches TF32 off for the whole process: every seed's
    # program runs with the switches a fresh process has, as in a benchmark run
    fresh = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for seed, control in runs:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = fresh
        ctx = harness.Context(args.workload, workload, seed, args.seconds, False,
                              torch.device("cuda"), time.perf_counter())
        ctx.control = control
        out = entry.run(ctx)
        line = {"workload": args.workload, "seed": seed, "control": control,
                "compared": {k: v["value"] for k, v in out["compared"].items()},
                "readings": out["readings"],
                "correct": out["correct"], "card": harness.power_limit()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
