"""Vector field -> spatial embedding: the N-step walk, in f32.

Port of ``skoots_tpu/ops/vec2embed.py``. A voxel's embedding starts at its
own coordinate plus its scaled vector; each further step re-reads the vector
at the rounded, clipped embedded position (``torch.round`` rounds half to
even, as ``jnp.round``) and adds it, scaled by ``scale * decay**step``.
``vector`` is channels-last ``[B, X, Y, Z, 3]`` (or ``[B, X, Y, 2]``).
Every ``position + vector * scale`` is one fused multiply-add (:func:`fma`),
as XLA compiles it, so the port's positions equal the JAX package's bit for
bit.

* ``_vec2embed`` -- the dense walk (``vec2embed.py:34-67``);
* ``_vec2embed_compact`` -- the same walk over the nonzero-vector voxels
  only (zero-vector voxels never move), bit-identical to the dense walk;
  torch's ``nonzero`` has no capacity, so no fallback is needed;
* ``_vec2embed_early`` -- the walk with the convergence early exit
  (``vec2embed.py:150-215``).
"""

from __future__ import annotations

import torch

from skoots_tpu_torch.utils import trace


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded ONCE (a fused multiply-add), exactly: the
    f64 product of two f32 values is exact, TwoSum gives the f64 sum's
    rounding error, and rounding that sum to odd before the f32 rounding
    rules out double rounding (53 >= 24 + 2 bits).

    Differentiable as ``a * b + c`` (the training loss goes through the
    walk's first step): the exact value plus the zero-valued difference
    ``lin - lin.detach()`` carries the gradient, so it does not depend on
    whether this torch build differentiates ``nextafter``."""
    with torch.no_grad():
        p = a.double() * b.double()
        cd = c.double()
        s = p + cd
        bb = s - cd
        err = (cd - (s - bb)) + (p - bb)
        inexact = (err != 0) & ((s.view(torch.int64) & 1) == 0)
        toward = torch.where(err > 0, float("inf"), float("-inf"))
        exact = torch.where(inexact, torch.nextafter(s, toward), s).float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, c)):
        lin = a * b + c
        return exact + (lin - lin.detach())
    return exact


def coordinate_mesh(spatial_shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """``[*spatial_shape, D]`` voxel coordinates (ij indexing) in ``dtype``."""
    axes = [torch.arange(s, dtype=dtype, device=device) for s in spatial_shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def _setup(scale, vector):
    spatial = tuple(vector.shape[1:-1])
    d = vector.shape[-1]
    dev = vector.device
    mesh = coordinate_mesh(spatial, device=dev)[None]
    trace.host_sync("vec2embed.scale_h2d", dev)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    vec = vector.float()
    embed = fma(vec, scale.view((1,) * (len(spatial) + 1) + (d,)), mesh)
    trace.host_sync("vec2embed.sizes_h2d", dev)
    sizes = torch.tensor(spatial, dtype=torch.int64, device=dev)
    strides = torch.ones(len(spatial), dtype=torch.int64, device=dev)
    for i in range(len(spatial) - 2, -1, -1):
        strides[i] = strides[i + 1] * spatial[i + 1]
    return spatial, d, scale, vec, embed, sizes, strides


def _ravel(e, sizes, strides):
    idx = torch.round(e).to(torch.int64).clamp(min=torch.zeros_like(sizes),
                                               max=sizes - 1)
    return (idx * strides).sum(-1)


def _vec2embed(scale, vector, n: int, decay: float = 1.0) -> torch.Tensor:
    spatial, d, scale, vec, embed, sizes, strides = _setup(scale, vector)
    b = vector.shape[0]
    flat_vec = vec.reshape(b, -1, d)
    # the JAX walk takes ``decay`` as a traced f32 scalar, so the step
    # factor accumulates in f32 here (the other walks use Python floats)
    trace.host_sync("vec2embed.decay_h2d", vector.device)
    decay32 = torch.tensor(decay, dtype=torch.float32, device=vector.device)
    step = torch.ones((), dtype=torch.float32, device=vector.device)
    for _ in range(n - 1):
        step = step * decay32
        flat_idx = _ravel(embed, sizes, strides).reshape(b, -1)
        delta = torch.gather(flat_vec, 1, flat_idx[..., None].expand(-1, -1, d))
        embed = fma(delta.reshape(embed.shape), scale * step, embed)
    return embed


def _vec2embed_compact(scale, vector, n: int, decay: float = 1.0) -> torch.Tensor:
    spatial, d, scale, vec, embed, sizes, strides = _setup(scale, vector)
    v = 1
    for s in spatial:
        v *= s
    flat_vec = vec.reshape(-1, d)
    emb_flat = embed.reshape(-1, d).clone()
    trace.host_sync("vec2embed.nonzero", flat_vec.device)
    sel = torch.nonzero((flat_vec != 0).any(-1)).squeeze(1)
    base = (sel // v) * v  # batch-local gathers stay in their batch
    cur = emb_flat[sel]
    step = 1.0
    for _ in range(n - 1):
        step = step * decay
        li = _ravel(cur, sizes, strides) + base
        cur = fma(flat_vec[li], scale * step, cur)
    emb_flat[sel] = cur
    return emb_flat.reshape(embed.shape)


def _vec2embed_early(scale, vector, n: int, decay: float, exit_fraction: float,
                     exit_cycle: bool = False) -> torch.Tensor:
    spatial, d, scale, vec, embed, sizes, strides = _setup(scale, vector)
    b = vector.shape[0]
    flat_vec = vec.reshape(b, -1, d)
    n_vox = flat_vec.shape[1] * b
    min_moving = max(exit_fraction, 0.0) * n_vox
    if n_vox <= min_moving:  # nothing can move less than everything
        return embed
    prev_idx = _ravel(embed, sizes, strides).reshape(b, -1)
    prev2_idx = torch.full_like(prev_idx, -1)
    step = 1.0
    for _ in range(n - 1):
        step = step * decay
        delta = torch.gather(flat_vec, 1, prev_idx[..., None].expand(-1, -1, d))
        embed = fma(delta.reshape(embed.shape), scale * step, embed)
        idx = _ravel(embed, sizes, strides).reshape(b, -1)
        moved = idx != prev_idx
        if exit_cycle:
            moved = moved & (idx != prev2_idx)  # period-2 = converged
        prev2_idx, prev_idx = prev_idx, idx
        trace.host_sync("vec2embed.poll", moved.device)
        if float(moved.sum()) <= min_moving:
            break
    return embed


def vector_to_embedding(
    scale,
    vector: torch.Tensor,
    n: int = 1,
    decay: float = 1.0,
    exit_fraction: float | None = None,
    exit_cycle: bool = False,
    compact_div: int | None = None,
) -> torch.Tensor:
    """Embeddings (f32, the shape of ``vector``) after ``n`` walk steps.
    ``compact_div`` selects the foreground-only walk (bit-identical, so its
    buffer size no longer matters and takes precedence over
    ``exit_fraction``, as in the JAX package); ``exit_fraction`` stops once
    no more than that fraction of voxels still change their rounded index
    (``exit_cycle``: a period-2 oscillation counts as settled)."""
    if vector.shape[-1] != len(scale):
        raise ValueError(f"scale {tuple(scale)} mismatches vector channels "
                         f"{vector.shape[-1]}")
    if compact_div is not None and n > 1:
        return _vec2embed_compact(scale, vector, int(n), float(decay))
    if exit_fraction is not None and n > 1:
        return _vec2embed_early(scale, vector, int(n), float(decay),
                                float(exit_fraction), bool(exit_cycle))
    return _vec2embed(scale, vector, int(n), float(decay))
