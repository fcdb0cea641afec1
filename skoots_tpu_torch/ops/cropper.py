"""Static sliding-window tile grid (numpy; copied from
``skoots_tpu/ops/cropper.py``): stride = crop - 2*overlap, edge tiles
clamped to ``shape - crop``, plus the canonical tile-size ladder, rounded
up (tiles reflect-padded past a short axis) or down (tiles sliced inside
it), and the host-side helpers :func:`get_total_num_crops` and
:func:`crops`."""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def _axis_origins(size: int, crop: int, overlap: int) -> List[int]:
    if crop >= size:
        return [0]
    stride = crop - 2 * overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} too large for crop {crop}")
    origins, x = [], 0
    while True:
        origins.append(min(x, size - crop))
        if x >= size - crop:
            return origins
        x += stride


def crop_origins(
    spatial_shape: Sequence[int],
    crop_size: Sequence[int],
    overlap: Sequence[int] = (0, 0, 0),
) -> List[Tuple[int, ...]]:
    """All tile origins for a spatial volume. Crop sizes are clamped to the
    volume."""
    crop = [min(c, s) for c, s in zip(crop_size, spatial_shape)]
    per_axis = [
        _axis_origins(s, c, o) for s, c, o in zip(spatial_shape, crop, overlap)
    ]
    grids = np.meshgrid(*per_axis, indexing="ij")
    return [tuple(int(g[idx]) for g in grids) for idx in np.ndindex(grids[0].shape)]


def effective_crop_size(
    spatial_shape: Sequence[int], crop_size: Sequence[int]
) -> Tuple[int, ...]:
    return tuple(min(c, s) for c, s in zip(crop_size, spatial_shape))


# Canonical tile ladder: a volume axis shorter than the requested crop is
# rounded UP to one of these sizes (and reflect-padded), so differently
# sized volumes share tile shapes. Consecutive gaps are <= 1.34x.
_BUCKETS = (
    list(range(4, 33, 4))
    + list(range(40, 65, 8))
    + list(range(80, 129, 16))
    + list(range(160, 257, 32))
    + list(range(320, 513, 64))
    + list(range(640, 4097, 128))
)


def bucket_up(size: int) -> int:
    """Smallest canonical tile size >= ``size`` (sizes < 4 pass through)."""
    if size < 4:
        return size
    for b in _BUCKETS:
        if b >= size:
            return b
    return ((size + 127) // 128) * 128


def bucket_down(size: int) -> int:
    """Largest canonical tile size <= ``size`` (sizes < 4 pass through)."""
    if size < 4:
        return size
    prev = _BUCKETS[0]
    for b in _BUCKETS:
        if b > size:
            return prev
        prev = b
    return prev


def bucketed_crop_size(
    crop_size: Sequence[int], spatial_shape: Sequence[int]
) -> Tuple[int, ...]:
    """The requested crop where the volume is large enough, else the volume
    axis rounded UP to the bucket ladder."""
    return tuple(
        c if d >= c else bucket_up(d) for c, d in zip(crop_size, spatial_shape)
    )


def bucketed_crop_size_down(
    crop_size: Sequence[int], spatial_shape: Sequence[int]
) -> Tuple[int, ...]:
    """Like :func:`bucketed_crop_size`, but short axes round DOWN (for
    consumers that slice tiles directly and cannot exceed the volume)."""
    return tuple(
        c if d >= c else bucket_down(d) for c, d in zip(crop_size, spatial_shape)
    )


def get_total_num_crops(
    spatial_shape: Sequence[int],
    crop_size: Sequence[int],
    overlap: Sequence[int],
) -> int:
    return len(crop_origins(spatial_shape, crop_size, overlap))


def crops(
    image,
    crop_size: Sequence[int],
    overlap: Sequence[int] = (0, 0, 0),
) -> Iterator[Tuple[object, Tuple[int, ...]]]:
    """Yield ``(crop, origin)`` over a channels-last volume ``[X, Y, Z, C]``
    (or ``[X, Y, Z]``; a numpy array or a tensor, sliced as views). For
    host-side tools; the inference paths cut their tiles from
    :func:`crop_origins` themselves."""
    spatial = tuple(image.shape[:3])
    crop = effective_crop_size(spatial, crop_size)
    for origin in crop_origins(spatial, crop, overlap):
        yield image[tuple(slice(o, o + c) for o, c in zip(origin, crop))], origin
