"""Crop the evaluation margin from a volume file (port of
``skoots_tpu/utils/remove_margin.py``): the reference's evaluation never
writes the outermost overlap band, so comparisons with its outputs crop it."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from skoots_tpu_torch.utils.io import imread, imsave


def remove_margin(path: str, margin: Tuple[int, int, int] = (50, 50, 5),
                  output_path: str | None = None) -> str:
    """Write ``path``'s volume without ``margin`` voxels on each side of
    each axis to ``output_path`` (default: ``_cropped`` before ``.tif``).
    Returns the path written."""
    vol = imread(path)
    if not all(2 * m < s for m, s in zip(margin, vol.shape)):
        raise ValueError(f"margin {margin} too large for volume {vol.shape}")
    sl = tuple(slice(m, -m if m else None) for m in margin)
    dest = output_path or path.replace(".tif", "_cropped.tif")
    imsave(dest, np.ascontiguousarray(vol[sl]))
    return dest
