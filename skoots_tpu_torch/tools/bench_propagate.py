"""Tile shape and passes per launch of the propagate kernel
(``csrc/propagate.cu``), measured on the card.

    python -m skoots_tpu_torch.tools.bench_propagate [--out FILE]

Builds the kernel's source once per candidate ``(QMAX, TX, TY, VZ, MINB)``
with ``-DPROP_QMAX=... -DPROP_TX=...`` and so on (one ``nvcc`` each, all
at once, into ``build/propagate_variants/``; ``-Xptxas -v`` gives
registers and spills), then on two cases:

- ``sparse``, the main path's: the dilated skeleton of the 512^3 bench
  phantom as the CC sees it, ``render_tubes(..., radius=3, noise=0) > 100``
  on ``tube_segments((512,)*3, 48, radius=5, seed=7)``, labels as
  ``ops/flood_fill.py`` starts them, 192 passes (one CC round), 26-conn;
- ``dense``: 30% random foreground at 512^3, 4 passes, 26-conn;

runs each candidate through the wrapper (``propagate(..., library=...)``:
its tile list, its launch plan over two buffers zeroed once a call),
requires the labels of as many plain passes exactly, and times it with
CUDA events (median of ``--repeats``). Prints one line a
candidate, its active-tile share on the sparse case and the two cases'
bounds, and writes the rows as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from skoots_tpu_torch.kernels import _build
from skoots_tpu_torch.kernels.propagate import launch_plan, propagate, propagate_ref
from skoots_tpu_torch.tools import median_ms

VOLUME = (512, 512, 512)
SPARSE_PASSES = 192
DENSE_PASSES = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# (QMAX, TX, TY, VZ, MINB): the halo tile is (TX + 2 QMAX) x (TY + 2 QMAX) x
# 32 VZ; MINB the blocks an SM must hold (the compiler caps registers so).
# The first is the package's build (csrc/propagate.cu's defaults)
CANDIDATES = (
    (2, 8, 8, 1, 3), (1, 16, 8, 1, 1), (2, 8, 8, 1, 2), (2, 8, 8, 1, 4),
    (2, 16, 8, 1, 2), (2, 8, 16, 1, 2), (3, 8, 8, 1, 3), (4, 8, 8, 1, 2),
    (4, 8, 16, 1, 1), (4, 16, 8, 1, 2), (4, 8, 8, 2, 1), (8, 16, 8, 1, 1),
)
VARIANT_DIR = _build.BUILD_DIR.parent / "propagate_variants"


def default_tile() -> tuple:
    """(QMAX, TX, TY, VZ): the compile-time defaults of the kernel's source,
    the tile the package's library builds."""
    text = (_build.CSRC / "propagate.cu").read_text()
    return tuple(int(re.search(rf"#define PROP_{k} (\d+)", text).group(1))
                 for k in ("QMAX", "TX", "TY", "VZ"))


def sparse_case(device) -> tuple:
    """(labels int32, fg uint8) of the main path's CC on the 512^3 bench
    phantom: its tube centrelines rendered at the dilated skeleton's
    radius."""
    from skoots_tpu_torch.ops.flood_fill import _init_labels
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    p0, p1, _ = tube_segments(VOLUME, 48, radius=5.0, seed=7)
    fg = render_tubes(VOLUME, p0, p1, radius=3.0, noise=0.0, device=device) > 100
    fg, labels = _init_labels(fg)
    return labels, fg


def dense_case(device, seed: int = 0) -> tuple:
    """(labels int32, fg uint8): 30% random foreground, which percolates,
    so labels move in every pass; labels voxel index + 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    fg = (torch.rand(VOLUME, device=device, generator=gen) < 0.3).to(torch.uint8)
    idx = torch.arange(1, fg.numel() + 1, dtype=torch.int32, device=device)
    return torch.where(fg > 0, idx.view(VOLUME), 0), fg


def sparse_bound_ms(fg: torch.Tensor, passes: int) -> float:
    """Least time of ``passes`` passes on a sparse mask: the mask read once
    and the labels written once (5 B a voxel), and each pass's foreground
    labels read and written (8 B a foreground voxel), at the HBM rate."""
    moved = 5.0 * fg.numel() + 8.0 * passes * float((fg > 0).sum())
    return moved / HBM_BYTES_PER_S * 1e3


def active_share(fg: torch.Tensor, tile: tuple) -> float:
    """Share of a candidate's tiles whose interior holds foreground."""
    qmax, tx, ty, vz = tile[:4]
    t = (tx, ty, 32 * vz - 2 * qmax)
    n = [-(-s // k) for s, k in zip(fg.shape, t)]
    pad = [v for s, k, m in reversed(list(zip(fg.shape, t, n))) for v in (0, m * k - s)]
    f = torch.nn.functional.pad((fg > 0).to(torch.uint8), pad)
    f = f.view(n[0], t[0], n[1], t[1], n[2], t[2]).amax(dim=(1, 3, 5))
    return float(f.float().mean())


def build_variants(tiles) -> dict:
    """``{tile: (library or None, ptxas / nvcc message)}``."""
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "propagate.cu"
    procs = {}
    for tile in tiles:
        defs = [f"-DPROP_{k}={v}" for k, v in zip(("QMAX", "TX", "TY", "VZ", "MINB"), tile)]
        out = VARIANT_DIR / ("libpropagate_q%d_%dx%d_vz%d_minb%d.so" % tile)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *defs, "-o", str(out),
               str(src)]
        procs[tile] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    built = {}
    for tile, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            built[tile] = (None, err.strip()[-400:])
            continue
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("skoots_propagate"):
                getattr(lib, name).argtypes = list(argtypes)
                getattr(lib, name).restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", err)
        spills = re.findall(r"(\d+) bytes spill stores", err)
        built[tile] = (lib, f"registers {'/'.join(regs)} spill stores {'/'.join(spills)}")
    return built


def measure(device=None, repeats: int = 5, tiles=CANDIDATES) -> list:
    """One row per candidate: ``{"tile", "build", "sparse_ms", "dense_ms",
    "sparse_ok", "dense_ok", "launches", "active_share"}`` (times None where
    it did not build or run)."""
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_propagate measures a CUDA card; none is available")
    built = build_variants(tiles)
    cases = {}
    for name, make, passes in (("sparse", sparse_case, SPARSE_PASSES),
                               ("dense", dense_case, DENSE_PASSES)):
        labels, fg = make(device)
        want = labels
        for _ in range(passes):
            want = propagate_ref(want, fg)
        cases[name] = (labels, fg, passes, want)
    labels, fg, _, _ = cases["sparse"]
    print(f"sparse: {int((fg > 0).sum())} foreground voxels of {fg.numel()}, "
          f"{SPARSE_PASSES} passes, bound {sparse_bound_ms(fg, SPARSE_PASSES):.4f} ms; "
          f"dense: {DENSE_PASSES} passes, bound "
          f"{9.0 * fg.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)
    rows = []
    for tile, (lib, note) in built.items():
        row = {"tile": list(tile), "build": note, "active_share": active_share(fg, tile),
               "launches": len(launch_plan(SPARSE_PASSES, tile[0]))}
        for name, (lab, f, passes, want) in cases.items():
            row[f"{name}_ms"] = row[f"{name}_ok"] = None
            if lib is None:
                continue
            try:
                got = propagate(lab, f, passes, library=lib)
                torch.cuda.synchronize()
            except RuntimeError as e:  # a launch the card refused
                row[f"{name}_ok"] = str(e)
                continue
            row[f"{name}_ok"] = bool(torch.equal(got, want))
            row[f"{name}_ms"] = median_ms(lambda: propagate(lab, f, passes, library=lib),
                                          repeats)
        rows.append(row)
        print(f"QMAX {tile[0]} interior {tile[1]}x{tile[2]}x{32 * tile[3] - 2 * tile[0]} "
              f"VZ {tile[3]} MINB {tile[4]}: sparse {row['sparse_ms']} ms "
              f"exact {row['sparse_ok']} "
              f"({row['launches']} launches, {row['active_share']:.4f} of tiles active), "
              f"dense {row['dense_ms']} ms exact {row['dense_ok']}; {note}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    rows = measure(repeats=args.repeats)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    bad = [r["tile"] for r in rows if r["sparse_ok"] is not True or r["dense_ok"] is not True]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
