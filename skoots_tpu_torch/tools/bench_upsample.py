"""Planes a thread marches over (``S``) in the upsample kernel
(``csrc/upsample.cu``), measured on the card.

    python -m skoots_tpu_torch.tools.bench_upsample [--out FILE]

On the main path's two decoder shapes (the 256^2 x 96 bench tile's
``[1, 64, 64, 24, 128]`` and ``[1, 128, 128, 48, 64]``), at bf16 and f32,
launches the kernel with each candidate ``S`` (the C entry point takes it
as an argument), requires the plain version's values bit for bit, and
times it with CUDA events (median of ``--repeats``). Prints one line a
candidate with the shape's byte bound, and writes the rows as JSON to
``--out``. The package's choice is ``kernels.upsample.SEGMENT_PLANES``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from skoots_tpu_torch.kernels import _build
from skoots_tpu_torch.kernels.upsample import SEGMENT_PLANES, upsample2x_ref
from skoots_tpu_torch.tools import median_ms

SHAPES = ((1, 64, 64, 24, 128), (1, 128, 128, 48, 64))
CANDIDATES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 48)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet


@_build.on_device
def launch(x: torch.Tensor, out: torch.Tensor, planes: int) -> None:
    b, xs, ys, zs, c = x.shape
    code = _build.library().skoots_upsample2x(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), b, xs, ys, zs, c,
        planes, _build.stream_ptr(x))
    _build.check(code, "upsample2x")


def measure(repeats: int = 5, shapes=SHAPES, candidates=CANDIDATES) -> list:
    """One row per (shape, dtype, S): ``{"shape", "dtype", "planes", "ms",
    "exact", "bound_ms"}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_upsample measures a CUDA card; none is available")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in shapes:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, device="cuda", generator=gen).to(dt)
            want = upsample2x_ref(x)
            out = torch.empty_like(want)
            bound = (x.numel() + want.numel()) * x.element_size() / HBM_BYTES_PER_S * 1e3
            for planes in candidates:
                if planes > shape[3]:
                    continue
                out.zero_()
                launch(x, out, planes)
                torch.cuda.synchronize()
                row = {"shape": list(shape), "dtype": str(dt)[6:], "planes": planes,
                       "exact": bool(torch.equal(out, want)),
                       "ms": median_ms(lambda: launch(x, out, planes), repeats),
                       "bound_ms": bound}
                rows.append(row)
                print(f"upsample {tuple(shape)} {row['dtype']} S={planes}"
                      f"{' (package)' if planes == SEGMENT_PLANES else ''}: "
                      f"{row['ms']:.4f} ms, bound {bound:.4f} ms, exact {row['exact']}",
                      flush=True)
            del x, want, out
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
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
