"""Build and load the hand-written CUDA kernels (``skoots_tpu_torch/csrc``).

At first use, every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface under
``build/kernels/`` at the checkout root, named by a hash of the sources and
flags, so a source change rebuilds and an unchanged tree reuses the library.
The library is loaded with :mod:`ctypes`: pointers and the CUDA stream pass
as ``c_void_p``; every entry point returns ``cudaGetLastError()`` and
:func:`check` raises on a non-zero code. A failed build raises; nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# storage-type codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # dtype, x, w, b, out, B, X, Y, Z, C, k, x_vstride, x_cstride, stream
    "skoots_dwconv3d": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _P),
    # dtype, x, shortcut, ls, lb, w1, b1, w2, b2, gamma, out, V, C, eps, stream
    "skoots_mlp_tail": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                        _F, _P),
    # dtype, x, ls, lb, w, b, out, V, C, N, eps, stream
    "skoots_ln_head": (_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _P),
    # labels_in, fg, labels_out, tiles, count, X, Y, Z, passes, connectivity,
    # stream
    "skoots_propagate": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # fg, tiles, count, X, Y, Z, stream: the call's list of tiles with
    # foreground
    "skoots_propagate_tiles": (_P, _P, _P, _I, _I, _I, _P),
    # -> the most passes one launch runs; X, Y, Z -> tiles of the volume
    # (counts, not errors)
    "skoots_propagate_qmax": (),
    "skoots_propagate_tile_count": (_I, _I, _I),
    # dtype, x, g, B, X, Y, Z, C, k, x_vstride, x_cstride, plan out (int32 [8])
    "skoots_dwconv3d_wgrad_plan": (_I, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _P),
    # dtype, x, g, partial, out, B, X, Y, Z, C, k, x_vstride, x_cstride,
    # plan, stream
    "skoots_dwconv3d_wgrad": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L,
                              _L, _P, _P),
    # mask, points, ids, P, X, Y, Z, wx, wy, wz, baked, dist, stream
    "skoots_bake": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P, _P, _P),
    # dtype, x, out, B, X, Y, Z, C, planes a thread marches over, stream
    "skoots_upsample2x": (_I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # dtype, a, b, out, n, iters, chains, stream
    "skoots_fma_chain": (_I, _P, _P, _P, _L, _I, _I, _P),
    # buf, w, out, dynamic, chains, reps, stream
    "skoots_loadfma": (_P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libskoots_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once and raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile the library if the current sources have not been built: one
    ``nvcc -c`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.tmp{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, cmds = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        cmds.append([_nvcc(), *compile_flags, "-c", str(src), "-o", str(obj)])
    try:
        _run_all(cmds)
        tmp = BUILD_DIR / f"{tag}.so"
        _run_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {t.device}")


def check_operands(what: str, device: torch.device, **operands) -> None:
    """Raise unless every ``name=(tensor, shape)`` lies on ``device`` with
    that shape: the kernels read raw pointers and trust both."""
    for name, (t, shape) in operands.items():
        if t.device != device or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} on {t.device}, "
                             f"expected {tuple(shape)} on {device}")
