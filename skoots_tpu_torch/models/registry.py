"""cfg -> model factory (port of ``skoots_tpu/models/registry.py``).

``cfg`` is the plain dict a ``.skoots`` checkpoint carries: ``bism_unext`` /
``unext`` build UNeXT3D, ``bism_unet`` / ``unet`` UNet3D, as in JAX.
"""

from __future__ import annotations

import math

import torch

from skoots_tpu_torch.models.spatial_embedding import SpatialEmbedding
from skoots_tpu_torch.models.unext import LayerNormParams, UNet3D, UNeXT3D

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def cfg_to_model(cfg: dict, device=None) -> SpatialEmbedding:
    """Build ``SpatialEmbedding(UNeXT3D | UNet3D)`` as described by
    ``cfg['MODEL']`` (parameters zero/one-initialised; load weights with
    :func:`load_flax_params`)."""
    m = cfg["MODEL"]
    arch = m["ARCHITECTURE"]
    dtype = _DTYPES[m.get("DTYPE", "bfloat16")]
    common = dict(in_channels=m["IN_CHANNELS"], out_channels=m["OUT_CHANNELS"],
                  dims=tuple(m["DIMS"]), depths=tuple(m["DEPTHS"]),
                  kernel_size=m["KERNEL_SIZE"], activation=m["ACTIVATION"], dtype=dtype,
                  device=device)
    if arch in ("bism_unext", "unext"):
        backbone = UNeXT3D(drop_path_rate=float(m["DROP_PATH_RATE"]),
                           layer_scale_init_value=m["LAYER_SCALE_INIT_VALUE"], **common)
    elif arch in ("bism_unet", "unet"):
        backbone = UNet3D(**common)  # JAX's UNet3D uses no DropPath or layer scale
    else:
        raise RuntimeError(f"{arch!r} is not a valid architecture; valid: "
                           "bism_unext, unext, bism_unet, unet")
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


# flax's lecun_normal: a normal truncated to [-2, 2] standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def init_parameters(model: SpatialEmbedding, seed: int) -> SpatialEmbedding:
    """Initialise ``model`` in place as flax initialises the JAX model, from
    a ``torch.Generator`` seeded with ``seed`` (so the same seed gives the
    same weights on any device; JAX's PRNG cannot be matched):

    * every kernel (``*.weight`` of a conv or dense layer): lecun_normal with
      flax's fan-in rule -- the product of all but the output axis of the
      flax kernel, i.e. ``k^3`` for a depthwise ``[k, k, k, 1, C]`` kernel,
      ``8 * Cin`` for the strided ``[2, 2, 2, Cin, C]`` Downsample, ``din``
      for a dense or 1x1 kernel, ``k^3 * Cin`` for a dense ``[k, k, k, Cin, C]``
      conv (UNet3D, a multi-channel stem);
    * biases 0, LayerNorm and GroupNorm scales 1, layer-scale ``gamma`` the
      config's ``LAYER_SCALE_INIT_VALUE`` (set by the constructor, left as
      it is).
    """
    gen = torch.Generator().manual_seed(int(seed))
    norms = {name for name, mod in model.named_modules()
             if isinstance(mod, LayerNormParams)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, leaf = name.rsplit(".", 1)
            if leaf == "gamma":
                continue
            if owner in norms:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            else:
                fan_in = math.prod(p.shape[:-1])
                w = torch.empty(p.shape, dtype=torch.float32)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_(w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
    return model


def init_model(cfg: dict, seed: int, device=None) -> SpatialEmbedding:
    """A freshly initialised model for ``cfg`` (:func:`init_parameters`)."""
    return init_parameters(cfg_to_model(cfg, device), seed)
