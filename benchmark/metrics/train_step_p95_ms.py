"""The 95th percentile of the window's step intervals: CUDA events recorded
on the stream at the start of each step (and one after the last), no
synchronisation added; linear interpolation between order statistics."""

import numpy as np


def read(raw):
    if raw["unit"] != "train_step" or not raw["intervals_ms"]:
        return None
    return float(np.percentile(np.asarray(raw["intervals_ms"]), 95))
