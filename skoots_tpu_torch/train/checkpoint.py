"""``.skoots`` checkpoints at the JAX package's path
(``skoots_tpu/train/checkpoint.py``): :func:`save_checkpoint` and
:func:`load_checkpoint` are ``skoots_tpu_torch.checkpoint``'s, and
:func:`restore_params` binds a loaded flax-layout parameter tree onto a
model. A reference ``.trch`` file converts with
``skoots_tpu_torch.utils.torch_compat.convert_trch``."""

from __future__ import annotations

from skoots_tpu_torch.checkpoint import MAGIC, load_checkpoint, save_checkpoint
from skoots_tpu_torch.models.registry import load_flax_params

__all__ = ["MAGIC", "load_checkpoint", "save_checkpoint", "restore_params"]


def restore_params(model, state_dict: dict):
    """Copy a flax parameter tree (``load_checkpoint(path)['params']``) into
    ``model`` and return it. As JAX's (flax's ``from_state_dict`` on a
    template), every leaf must map onto a parameter of the same shape and
    every parameter must be filled; the model carries its weights, so it
    takes the template's place."""
    return load_flax_params(model, state_dict)
