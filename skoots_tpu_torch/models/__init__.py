"""Models of the port: ``SpatialEmbedding(UNeXT3D | UNet3D)`` built from a
cfg (``skoots_tpu/models``)."""

from skoots_tpu_torch.models.registry import (
    cfg_to_model,
    init_model,
    load_flax_params,
    model_from_checkpoint,
)
from skoots_tpu_torch.models.spatial_embedding import SpatialEmbedding, split_output
from skoots_tpu_torch.models.unext import UNet3D, UNeXT3D

__all__ = [
    "cfg_to_model",
    "init_model",
    "SpatialEmbedding",
    "split_output",
    "UNeXT3D",
    "UNet3D",
    "load_flax_params",
    "model_from_checkpoint",
]
