"""Annealed Gaussian bandwidth of the embedding loss (port of
``skoots_tpu/train/sigma.py``): sigma at epoch ``e`` is the initial sigma
times the product of every multiplier whose epoch is below ``e``; computed
on the host in f32 numpy, as the JAX package's ``Sigma.host``."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class Sigma:
    def __init__(self, adjustments: List[dict],
                 initial_sigma: Sequence[float] = (0.1, 0.1, 0.8)):
        self.initial_sigma = np.asarray(initial_sigma, np.float32)
        self.values = np.asarray([1.0] + [float(d["multiplier"]) for d in adjustments],
                                 np.float32)
        self.epochs = np.asarray([-1] + [int(d["epoch"]) for d in adjustments],
                                 np.int32)

    def __call__(self, e: int) -> np.ndarray:
        """Sigma ``[x, y, z]`` (f32) at epoch ``e``."""
        mult = np.prod(np.where(self.epochs < e, self.values, np.float32(1.0)))
        return (self.initial_sigma * mult).astype(np.float32)


def init_sigma(cfg: dict) -> Sigma:
    adjustments = [{"multiplier": a, "epoch": b} for a, b in cfg["TRAIN"]["SIGMA_DECAY"]]
    return Sigma(adjustments, initial_sigma=cfg["TRAIN"]["INITIAL_SIGMA"])
