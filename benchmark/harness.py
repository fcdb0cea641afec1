"""The benchmark's driver: one cell, one seed, one run, one result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name under ``benchmark/``:

* ``workloads/<name>.json``: the configuration, the traffic mix and the entry;
* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<mix>.json``: the mix's parameters, read by the general generator
  ``traffic/<kind>.py`` that the mix names;
* ``entries/<entry>.py``: what a unit of work is (a block, a train step), its
  set-up, its window and the comparison that decides ``correct``;
* ``metrics/<metric>.py``: one reader a metric, ``read(raw) -> number | None``;
* ``kernels/<family>.py``: a kernel family's name patterns and its work.

Which metrics a run reports comes from ``BENCHMARK.json``: with ``--trace 0``
the end-to-end metrics of the cell, with ``--trace 1`` its per-layer metrics.
A run fails without a card, or with fewer cards than the cell asks for; it
never falls back to the CPU. It prints every number compared beside its
limit on standard error, and last on standard output one JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "skoots_tpu")
PEAK_BF16_FLOP_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = BENCH):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str, root: Path = BENCH) -> list:
    """Every ``<root>/<kind>/*<suffix>`` by name, sorted."""
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".")[0] in FORBIDDEN)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The entries of ``BENCHMARK.json`` this cell reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones (those that list the cell,
    or list none and move an end-to-end metric the cell reports)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def bound_s(moved: float, fp32_flops: float = 0.0, tensor_flops: float = 0.0) -> float:
    """The least seconds the work can take on one H100: the larger of the
    bytes over 3.35 TB/s and the operations over their type's peak (67
    TFLOP/s FP32 outside the tensor cores, 989 TFLOP/s bf16 on them); copied
    from the port's ``tools/bench_train_kernels.py::bound``."""
    t_bytes = moved / 3.35e12
    t_ops = max(fp32_flops / 67e12, tensor_flops / PEAK_BF16_FLOP_S)
    return max(t_bytes, t_ops)


class Trace:
    """``torch.profiler`` over the measured window; on exit reduces its
    events to the device's busy seconds (the union of kernel intervals), the
    window's length, kernel seconds by name and the longest idle gaps, each
    labelled by the host operation running in it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(_raw_events(self.prof), window_s)
        return False


def _raw_events(prof):
    """``(start ns, end ns, name, on the device)`` of every event the
    profiler kept, read from its raw Kineto results (building its Python
    event tree takes minutes for a window of training steps)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((start, start + e.duration_ns(), e.name(),
                    str(e.device_type()).endswith("CUDA")))
    return out


def reduce_events(events, window_s: float) -> dict:
    """Busy seconds, kernel seconds by name and the longest idle gaps, from
    ``(start ns, end ns, name, on the device)`` events."""
    kernels = sorted(e[:3] for e in events if e[3])
    host = sorted(e[:3] for e in events if not e[3])
    by_name: dict = {}
    for s, t, n in kernels:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-9
    busy, gaps, end = 0, [], None
    for s, t, _ in kernels:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end, s))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    starts = [h[0] for h in host]
    labelled = []
    for length, a, b in sorted(gaps, reverse=True)[:10]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        inside = [h for h in host[max(0, i - 2000):i] if h[1] >= mid]
        label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "no host op"
        labelled.append([f"host: {label}", length * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-9, "window_s": window_s, "kernels": by_name,
            "device_ops": [[n, t] for n, t in top], "idle_gaps": labelled}


def report(checks: list) -> dict:
    """Print each compared number beside its limit on standard error; the
    dict of them for the result line. ``checks``: (name, value, limit)."""
    out = {}
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
        out[name] = {"value": value, "limit": limit}
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    fixed_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    import skoots_tpu_torch

    where = Path(skoots_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"no result: the program imported from {where}, outside the checkout {ROOT}",
              file=sys.stderr)
        return 4
    workload = load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"no result: the cell needs {workload['chips']} CUDA card(s), "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    wanted = cell_metrics(spec, args.workload, bool(args.trace))

    ctx = Context(args.workload, workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda"), t_start)
    torch.cuda.init()
    ctx.mark("torch imported, card initialised")
    entry = load_module("entries", workload["entry"])
    out = entry.run(ctx)

    found = forbidden_modules()
    if found:
        print(f"no result: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    metrics = {}
    for m in wanted:
        value = load_module("metrics", m["name"]).read(out["raw"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limit = power_limit()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(workload["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "name_and_power_limit": limit}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device}
    tr = out["raw"].get("trace")
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["compared"] = out["compared"]
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


class Context:
    """What an entry gets: the cell, its configuration and mix, the seed,
    the window's length, whether to trace, the device, the process's start."""

    def __init__(self, name, workload, seed, seconds, trace, device, t_start):
        self.name = name
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.root = BENCH
        self.config = load_json("configs", workload["config"])
        self.mix = load_json("traffic", workload["traffic"])
        self.generator = load_module("traffic", self.mix["kind"])

    def mark(self, what: str) -> None:
        """Log a set-up step's end, seconds since the process started."""
        print(f"# {time.perf_counter() - self.t_start:8.2f} s  {what}", file=sys.stderr,
              flush=True)
