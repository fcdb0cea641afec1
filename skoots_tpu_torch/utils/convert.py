"""Artifact -> tif converter: ``skoots-torch --convert`` (a copy of
``skoots_tpu/utils/convert.py:13-50``, writing through the port's
:func:`skoots_tpu_torch.utils.io.imsave`)."""

from __future__ import annotations

import os

import numpy as np

from skoots_tpu_torch.utils.io import imsave


def convert(path: str) -> str:
    """Convert a saved volume artifact (.npy / .npz / .h5 / .trch) to tif.

    Vector fields in [-1, 1] (last dim 3) are rescaled to uint8 via
    v * 127 + 127 and written one tif per component; float volumes in
    [0, 1] are scaled to uint8; label volumes are saved as they are.
    Returns the path written (a glob for a vector field)."""
    stem, ext = os.path.splitext(path)
    if ext == ".trch":
        import torch

        arr = np.asarray(torch.load(path, map_location="cpu", weights_only=False))
    elif ext == ".npy":
        arr = np.load(path, mmap_mode="r")
    elif ext == ".npz":
        with np.load(path) as z:
            arr = z[z.files[0]]
    elif ext in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            arr = f[next(iter(f.keys()))][...]
    else:
        raise RuntimeError(f"cannot convert {ext!r} files")

    arr = np.asarray(arr)
    if arr.ndim == 4 and arr.shape[-1] == 3:  # vector field [X, Y, Z, 3]
        arr = (arr.astype(np.float32) * 127 + 127).clip(0, 255).astype(np.uint8)
        for c in range(3):
            imsave(f"{stem}_vec{c}.tif", arr[..., c])
        return f"{stem}_vec*.tif"
    if arr.ndim == 4 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    out = stem + ".tif"
    if arr.dtype in (np.float32, np.float64, np.float16):
        arr = (arr.astype(np.float32).clip(0, 1) * 255).astype(np.uint8)
    imsave(out, arr)
    return out
