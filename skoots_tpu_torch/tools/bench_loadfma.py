"""Shared-memory load + FMA rate of the card in the depthwise conv's access
pattern (``kernels/microbench.py::loadfma``): 343 taps per output column
over a [72, 16, 128] f32 buffer, static or dynamic source rows, 1 or 8
accumulator chains -- the four variants of the TPU tool.

    python -m skoots_tpu_torch.tools.bench_loadfma

Each variant runs once at the tool's size (one grid of 16 blocks, far from
filling the card) and with enough independent copies of the grid to fill
every SM several times. Each is checked exactly against the plain version
on integer-valued inputs (every product and partial sum is an exact f32
integer), then timed with CUDA events (median of ``repeats``); TFLOP/s
counts 2 flops per tap per lane. Prints one line per row and returns the
rows.

:func:`sass_counts` reads what each variant issues a column from the built
library (``cuobjdump -sass``): FFMA, and the shared-memory loads (LDS) of
the source rows (one address a lane) and of the weights (one address a
warp, a broadcast), in the column loop and once a thread.
:func:`variant_bound` turns those counts into the variant's least time: the
larger of its FFMA issue time (4 warp FFMA a clock an SM, the FP32 peak)
and its shared-memory time (one 128-byte wavefront a clock an SM: a 32-bit
row load of 32 lanes is one, a 64- or 128-bit one two or four, a broadcast
weight load one), at the card's SM count and maximum SM clock.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np
import torch

from skoots_tpu_torch.kernels.microbench import COLS, SHAPE, TAPS, loadfma, loadfma_ref
from skoots_tpu_torch.tools import median_ms

VARIANTS = (("static", False, 1), ("dynamic", True, 1), ("static_chains8", False, 8),
            ("dynamic_chains8", True, 8))


def fill_reps(device: torch.device) -> int:
    """Copies of the 16-block grid: three per SM (six blocks of 37 KB of
    shared memory fit an SM), so 8 waves of blocks."""
    return 3 * torch.cuda.get_device_properties(device).multi_processor_count


def measure(device=None, repeats: int = 5, seed: int = 0) -> list:
    """One row per (variant, reps): ``{"variant", "reps", "ms", "tflops",
    "flops"}``; raises if a kernel disagrees with its plain
    version."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_loadfma measures a CUDA card; none is available")
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(-8, 9, SHAPE).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.integers(-8, 9, (1, 128)).astype(np.float32)).to(device)
    rows = []
    for name, dynamic, chains in VARIANTS:
        want = loadfma_ref(buf, w, dynamic, chains)
        for reps in (1, fill_reps(device)):
            got = loadfma(buf, w, dynamic, chains, reps)
            torch.cuda.synchronize()
            mism = int((got != want[None]).sum())
            if mism:
                raise RuntimeError(f"loadfma {name} reps {reps}: {mism} values differ")
            ms = median_ms(lambda: loadfma(buf, w, dynamic, chains, reps), repeats)
            flops = float(reps) * COLS * TAPS * SHAPE[1] * SHAPE[2] * 2
            rows.append({"variant": name, "reps": reps, "ms": ms, "flops": flops,
                         "tflops": flops / ms / 1e9})
            print(f"loadfma {name} reps {reps}: {ms:.4f} ms "
                  f"{rows[-1]['tflops']:.2f} TFLOP/s (exact against the plain version)",
                  flush=True)
    return rows


# lanes a thread owns in the kernel (csrc/microbench.cu: 16-byte row loads
# for the dynamic variants), threads in a block
VECTOR_LANES = {True: 4, False: 1}
THREADS = 256
LANES_PER_BLOCK = 128


def _sass_loop_counts(lines: list) -> dict:
    """FFMA, per-lane LDS wavefronts and broadcast LDS of one function's
    SASS, inside its column loop (the backward branch whose span holds the
    most FFMA) and outside it. Branch targets are labels (``.L_x_N``) or
    addresses; instructions are placed by their ``/*addr*/``."""
    insts, labels, pending = [], {}, []
    for line in lines:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        a = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if a:
            addr = int(a.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insts.append((addr, a.group(2)))
    span, best = (0, -1), 0
    for addr, text in insts:
        m = re.search(r"\bBRA\b[^;]*?(?:(\.L_x_\d+)|0x([0-9a-f]+))", text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target < addr:
            n = sum("FFMA" in t for a, t in insts if target <= a <= addr)
            if n > best:
                span, best = (target, addr), n
    out = {f"{k}_{where}": 0 for k in ("ffma", "row_wavefronts", "lds_rows", "lds_weights")
           for where in ("loop", "once")}
    for addr, text in insts:
        where = "loop" if span[0] <= addr <= span[1] else "once"
        op = re.match(r"(?:@!?U?P\w+\s+)?(FFMA|LDS)(\S*)\s+([^;]*)", text)
        if not op:
            continue
        if op.group(1) == "FFMA":
            out[f"ffma_{where}"] += 1
            continue
        width = re.search(r"\.(64|128)", op.group(2))
        ref = re.search(r"\[([^\]]*)\]", op.group(3))
        if ref and re.search(r"(?<!U)\bR(?!Z)\d+", ref.group(1)):  # a per-lane address
            out[f"lds_rows_{where}"] += 1
            out[f"row_wavefronts_{where}"] += int(width.group(1)) // 32 if width else 1
        else:
            out[f"lds_weights_{where}"] += 1
    return out


def sass_counts(lib_path) -> dict:
    """Per variant name, what a thread issues for one output column of its
    ``VECTOR_LANES`` lanes, from the SASS of ``loadfma_kernel<DYNAMIC,
    CHAINS, VL>``: ``ffma``, ``lds_rows`` (per-lane loads of source rows)
    and their ``row_wavefronts`` (a 32-, 64- or 128-bit load of 32 lanes is
    1, 2 or 4), ``lds_weights`` (broadcast loads), each the column loop's
    count over the compiler's unroll of it plus what runs once, spread over
    the thread's columns; ``unroll`` and ``columns`` (per thread) beside."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    names = {(dyn, ch): name for name, dyn, ch in VARIANTS}
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"loadfma_kernelILb([01])ELi(\d+)E", line)
            name = names[(m.group(1) == "1", int(m.group(2)))] if m else None
            if name:
                funcs[name] = []
        elif name:
            funcs[name].append(line)
    out = {}
    for name, lines in funcs.items():
        dynamic = dict((n, d) for n, d, _ in VARIANTS)[name]
        vl = VECTOR_LANES[dynamic]
        columns = COLS // (THREADS // (LANES_PER_BLOCK // vl))
        c = _sass_loop_counts(lines)
        unroll = max(1, round(c["ffma_loop"] / (TAPS * vl)))
        row = {k: (c[f"{k}_loop"] / unroll + c[f"{k}_once"] / columns)
               for k in ("ffma", "row_wavefronts", "lds_rows", "lds_weights")}
        out[name] = {**row, "unroll": unroll, "columns": columns, "lanes": vl}
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``)."""
    q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True,
                       check=True, timeout=60).stdout.split()[0]
    return float(q) * 1e6


def variant_bound(counts: dict, reps: int, sms: int, clock_hz: float):
    """(least ms, what bounds it, FFMA ms, shared-memory ms) of one variant
    over ``reps`` grids: every thread column (``counts["lanes"]`` lanes)
    issues ``counts["ffma"]`` FFMA, 4 warp instructions a clock an SM, and
    ``row_wavefronts + lds_weights`` shared-memory wavefronts, one a clock
    an SM."""
    warp_columns = float(reps) * COLS * SHAPE[1] * SHAPE[2] / (32 * counts["lanes"])
    ffma_ms = warp_columns * counts["ffma"] / (4.0 * sms * clock_hz) * 1e3
    smem_ms = (warp_columns * (counts["row_wavefronts"] + counts["lds_weights"])
               / (sms * clock_hz) * 1e3)
    return (max(ffma_ms, smem_ms), "operations" if ffma_ms >= smem_ms else "shared memory",
            ffma_ms, smem_ms)


def main() -> int:
    rows = measure()
    from skoots_tpu_torch.kernels import _build

    counts = sass_counts(_build.library_path())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    for r in rows:
        least, by, f, m = variant_bound(counts[r["variant"]], r["reps"], sms, clock)
        print(f"loadfma {r['variant']} reps {r['reps']}: SASS {counts[r['variant']]}, bound "
              f"{least:.4f} ms ({by}; FFMA {f:.4f}, shared {m:.4f}), "
              f"{100 * least / r['ms']:.1f}% of it", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
