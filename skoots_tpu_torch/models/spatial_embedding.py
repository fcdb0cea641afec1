"""SpatialEmbedding head: backbone features -> the 5-channel SKOOTS output.

Port of ``skoots_tpu/models/spatial_embedding.py:30-38``: three 1^3-conv
heads at the model dtype, ``tanh`` on the 3 vector channels and ``sigmoid``
on the skeleton and semantic channels (computed at the model dtype, as
flax does), concatenated channels-last and cast to f32:
``out[..., 0:3]`` vectors, ``out[..., 3]`` skeleton, ``out[..., 4]``
semantic probability (:func:`split_output`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from skoots_tpu_torch.models.unext import Dense, dense


class SpatialEmbedding(nn.Module):
    def __init__(self, backbone: nn.Module, feat: int,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.backbone = backbone
        self.vector_head = Dense(feat, 3, device)
        self.skeleton_head = Dense(feat, 1, device)
        self.semantic_head = Dense(feat, 1, device)

    def forward(self, x: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` ``[B, X, Y, Z, 1]`` (normalised image) -> ``[B, X, Y, Z, 5]``
        f32. In eval mode (inference) no autograd graph is recorded; in
        train mode the output is differentiable, through the kernels'
        autograd wrappers. ``drop_gen`` draws the backbone's DropPath masks
        in training (None: no DropPath)."""
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self._forward(x, drop_gen)

    def _forward(self, x: torch.Tensor,
                 drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.heads(self.backbone(x, drop_gen))

    def heads(self, feat: torch.Tensor) -> torch.Tensor:
        """The 5-channel output from backbone features (pointwise, so a
        sharded forward runs it on each slab)."""
        heads = (self.vector_head, self.skeleton_head, self.semantic_head)
        # the three 1x1 heads as one matmul: each output column is its own
        # f32 dot product, so the columns equal three separate convs
        w = torch.cat([h.weight for h in heads], dim=1)
        b = torch.cat([h.bias for h in heads])
        y = dense(feat, w, b, self.compute_dtype)
        out = torch.cat([torch.tanh(y[..., 0:3]), torch.sigmoid(y[..., 3:5])], -1)
        return out.float()


def split_output(out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vectors ``[..., 3]``, skeleton probability ``[..., 1]``, semantic
    probability ``[..., 1]``) of a channels-last model output, as views."""
    return out[..., 0:3], out[..., 3:4], out[..., 4:5]
