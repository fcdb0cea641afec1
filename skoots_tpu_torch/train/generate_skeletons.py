"""Ground-truth skeleton files (port of
``skoots_tpu/train/generate_skeletons.py:221-236``): ``.skeletons.npz``
holds one ``[M, 3]`` f32 array per instance id; the reference's
``.skeletons.trch`` is read with ``torch.load``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_skeletons(path: str, skeletons: Dict[int, np.ndarray]) -> None:
    np.savez_compressed(path, **{str(k): v for k, v in skeletons.items()})


def load_skeletons(path: str) -> Dict[int, np.ndarray]:
    if path.endswith(".trch"):
        import torch

        d = torch.load(path, map_location="cpu", weights_only=False)
        return {int(k): np.asarray(v, np.float32) for k, v in d.items()}
    with np.load(path) as z:
        return {int(k): z[k].astype(np.float32) for k in z.files}


def calculate_skeletons(masks: np.ndarray, *args, **kwargs) -> Dict[int, np.ndarray]:
    """Skeletonising instance masks is not ported yet (see ROADMAP.md):
    make the ``.skeletons.npz`` files with the JAX package's
    ``skoots --skeletonize-train-data``."""
    raise NotImplementedError(
        "calculate_skeletons is not ported yet (see ROADMAP.md); write the "
        ".skeletons.npz files with `skoots --skeletonize-train-data DIR`")
