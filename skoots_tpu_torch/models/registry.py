"""cfg -> model factory (port of ``skoots_tpu/models/registry.py``).

``cfg`` is the plain dict a ``.skoots`` checkpoint carries. The port builds
the ``bism_unext`` / ``unext`` architecture; any other raises
``NotImplementedError`` (``bism_unet`` is queued in ROADMAP.md).
"""

from __future__ import annotations

import torch

from skoots_tpu_torch.models.spatial_embedding import SpatialEmbedding
from skoots_tpu_torch.models.unext import UNeXT3D

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def cfg_to_model(cfg: dict, device=None) -> SpatialEmbedding:
    """Build ``SpatialEmbedding(UNeXT3D)`` as described by ``cfg['MODEL']``
    (parameters zero/one-initialised; load weights with
    :func:`load_flax_params`)."""
    m = cfg["MODEL"]
    arch = m["ARCHITECTURE"]
    if arch not in ("bism_unext", "unext"):
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (see ROADMAP.md); "
            "the port builds 'bism_unext' / 'unext'")
    dtype = _DTYPES[m.get("DTYPE", "bfloat16")]
    backbone = UNeXT3D(
        in_channels=m["IN_CHANNELS"], out_channels=m["OUT_CHANNELS"],
        dims=tuple(m["DIMS"]), depths=tuple(m["DEPTHS"]),
        kernel_size=m["KERNEL_SIZE"],
        layer_scale_init_value=m["LAYER_SCALE_INIT_VALUE"],
        activation=m["ACTIVATION"], dtype=dtype, device=device,
    )
    return SpatialEmbedding(backbone, m["OUT_CHANNELS"], dtype, device).eval()


def load_flax_params(model: SpatialEmbedding, params_np: dict) -> SpatialEmbedding:
    """Copy a flax parameter tree (``checkpoint['params']``) into ``model``;
    every leaf must map and every parameter must be filled."""
    from skoots_tpu_torch.checkpoint import torch_params_from_flax

    model.load_state_dict(torch_params_from_flax(params_np), strict=True)
    return model


def model_from_checkpoint(ckpt: dict, device=None) -> SpatialEmbedding:
    """The model of a loaded checkpoint, with its weights, on ``device``."""
    return load_flax_params(cfg_to_model(ckpt["cfg"], device), ckpt["params"])
