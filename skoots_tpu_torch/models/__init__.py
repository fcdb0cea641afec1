"""Models of the port: ``SpatialEmbedding(UNeXT3D)`` built from a cfg dict."""

from skoots_tpu_torch.models.registry import (
    cfg_to_model,
    init_model,
    load_flax_params,
    model_from_checkpoint,
)

__all__ = ["cfg_to_model", "init_model", "load_flax_params", "model_from_checkpoint"]
