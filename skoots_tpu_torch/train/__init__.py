"""Training of the port: ``python -m skoots_tpu_torch.train --config-file
cfg.yaml`` (``cli.py``), the engine (``engine.py``), on-device augmentation
(``transforms.py``), the host data pipeline (``data.py``), the losses
(``losses.py``) and ``.skoots`` checkpoints (``checkpoint.py``)."""

from skoots_tpu_torch.train.losses import (
    cfg_loss,
    dice,
    jaccard,
    soft_cldice,
    soft_dice_cldice,
    soft_skeletonize,
    split_loss,
    tversky,
)
from skoots_tpu_torch.train.sigma import Sigma, init_sigma

__all__ = [
    "cfg_loss",
    "dice",
    "jaccard",
    "soft_cldice",
    "soft_dice_cldice",
    "soft_skeletonize",
    "split_loss",
    "tversky",
    "Sigma",
    "init_sigma",
]
