"""Host C++ libraries of the port (``csrc/host/*.cpp``), built at first use.

A source is compiled by the system C++ compiler (``g++ -O3 -shared -fPIC``)
into ``build/host/`` at the checkout root, named by a hash of the source and
flags, and loaded with :mod:`ctypes`. These libraries are kept apart from
the CUDA library (``kernels/_build.py``), so they build wherever a C++
compiler exists, with or without a card. A failed build raises; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(name: str) -> Path:
    """Where ``csrc/host/<name>.cpp`` is built: ``build/host/lib<name>_<hash>.so``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((SOURCE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """``csrc/host/<name>.cpp`` built (once per source hash) and loaded."""
    source = SOURCE_DIR / f"{name}.cpp"
    out = library_path(name)
    if not out.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (g++) found: {source.name} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.stem}.tmp{os.getpid()}.so"
        proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
