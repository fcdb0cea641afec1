"""Contiguous relabelling of an instance-mask file (port of
``skoots_tpu/utils/renumber.py``)."""

from __future__ import annotations

import logging

import numpy as np

from skoots_tpu_torch.ops.flood_fill import renumber
from skoots_tpu_torch.utils.io import imread, imsave

log = logging.getLogger(__name__)


def load_renumber_save(path: str, output_path: str | None = None) -> str:
    """Load an instance mask, compact its ids to 1..N and save it as int32
    to ``output_path`` (default: over ``path``). Returns the path written."""
    out, mapping = renumber(imread(path).astype(np.int64))
    dest = output_path or path
    imsave(dest, out.astype(np.int32))
    log.info("renumbered %d ids -> %s", len(mapping), dest)
    return dest
