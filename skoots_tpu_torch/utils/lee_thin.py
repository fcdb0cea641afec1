"""Lee 3D medial-axis thinning on the host (``csrc/host/lee_thin.cpp``),
built by ``g++`` at first use (:mod:`skoots_tpu_torch.utils.host_lib`)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from skoots_tpu_torch.utils import host_lib

SOURCE = host_lib.SOURCE_DIR / "lee_thin.cpp"


def library_path():
    return host_lib.library_path("lee_thin")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = host_lib.library("lee_thin")
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
