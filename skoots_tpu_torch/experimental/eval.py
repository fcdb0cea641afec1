"""The tuned ``--experimental`` inference (port of
``skoots_tpu/experimental/eval.py``): the standard engine with the
original SKOOTS's experimental knobs -- probability threshold 0.5, no 3D
and three 2D dilations, and an N = 10 embedding walk with decay 0.95."""

from __future__ import annotations

import numpy as np

from skoots_tpu_torch.infer.engine import run_inference

_TUNED = {
    "prob_threshold": 0.5,
    "dilation_3d": 0,
    "dilation_2d": 3,
    "embed_iterations": 10,
    "embed_decay": 0.95,
}


def eval(image_path: str, checkpoint_path: str, **kwargs) -> np.ndarray:
    """:func:`run_inference` with the tuned knobs. A kwarg passed as None
    counts as unset (the CLI forwards its auto dilation knobs as None), so
    the tuned value applies; any other value overrides it."""
    for k, v in _TUNED.items():
        if kwargs.get(k) is None:
            kwargs[k] = v
    return run_inference(image_path, checkpoint_path, **kwargs)
