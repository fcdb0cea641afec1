"""Lee 3D medial-axis thinning on the host (``csrc/host/lee_thin.cpp``).

At first use the C++ source is compiled by the system C++ compiler
(``g++ -O3 -shared -fPIC``) into ``build/host/`` at the checkout root, named
by a hash of the source and flags, and loaded with :mod:`ctypes`. It is
kept apart from the CUDA library (``kernels/_build.py``), so it builds
wherever a C++ compiler exists, with or without a card. A failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "lee_thin.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblee_thin_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) found: Lee thinning cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}.so"
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.lee_thin_3d.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int64]
    lib.lee_thin_3d.restype = ctypes.c_int64
    return lib


def lee_thin(binary: np.ndarray) -> np.ndarray:
    """The skeleton (bool, the shape of ``binary``) of a 3D binary volume:
    border peeling in six directions, endpoints kept, simple points
    deleted with a sequential re-check, until nothing changes."""
    vol = np.asarray(binary)
    if vol.ndim != 3:
        raise ValueError(f"lee_thin needs a 3D volume, got shape {vol.shape}")
    out = np.ascontiguousarray(vol > 0, np.uint8).copy()
    x, y, z = out.shape
    library().lee_thin_3d(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), x, y, z)
    return out > 0
