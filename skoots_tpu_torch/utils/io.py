"""Volume I/O (port of ``skoots_tpu/utils/io.py``): TIFF, NPY, HDF5, and the
disk-backed ``.npy`` memmaps of out-of-core inference.

Canonical layout: a volume is ``[X, Y, Z]`` on the host; a multi-page TIFF
stores one page per Z, page rows = X, page cols = Y. Pillow (TIFF) and h5py
(HDF5) are imported only inside the functions that need them, so the rest of
the port imports without them.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _canon_np(vol: np.ndarray) -> np.ndarray:
    if vol.ndim == 2:
        vol = vol[..., None]
    if vol.ndim != 3:
        raise ValueError(f"expected a 2D/3D volume, got shape {vol.shape}")
    return vol


def imread(path: str) -> np.ndarray:
    """Read a 2D or 3D (multi-page) image into ``[X, Y, Z]``. Multi-channel
    pages keep channel 2 if there are more than 3 channels, else channel 0."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return _canon_np(np.load(path, mmap_mode="r"))
    if ext in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            return _canon_np(f[next(iter(f.keys()))][...])

    from PIL import Image, ImageSequence

    Image.MAX_IMAGE_PIXELS = None  # EM slices are big; trust local files
    with Image.open(path) as img:
        pages = []
        for frame in ImageSequence.Iterator(img):
            arr = np.asarray(frame)
            if arr.ndim == 3:  # [X, Y, C]
                arr = arr[..., 2] if arr.shape[-1] > 3 else arr[..., 0]
            pages.append(arr)
    vol = np.stack(pages, axis=0)  # [Z, X, Y]
    return np.ascontiguousarray(vol.transpose(1, 2, 0))


def imsave(path: str, volume: np.ndarray) -> None:
    """Save an ``[X, Y, Z]`` volume; TIFF is written one page per Z."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        np.save(path, volume)
        return
    if ext in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("volume", data=volume, compression="gzip")
        return

    from PIL import Image

    vol = volume.transpose(2, 0, 1)  # [Z, X, Y]
    if vol.dtype in (np.int64, np.uint64):
        vol = vol.astype(np.int32)
    frames = [Image.fromarray(p) for p in vol]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   compression="tiff_deflate")


def open_outofcore(path: str, shape: Tuple[int, ...], dtype: str) -> np.memmap:
    """A new disk-backed host buffer: a flat ``.npy`` memmap (no chunk codec
    on the write path), readable by ``np.load(path, mmap_mode="r")``."""
    return np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)


def load_outofcore(path: str) -> np.memmap:
    return np.lib.format.open_memmap(path, mode="r+")
