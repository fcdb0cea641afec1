"""Spatially-sharded inference over a device mesh that one process drives.

Port of ``skoots_tpu/infer/sharded.py``. The volume's X axis is split into
slabs, one a device of the mesh's ``space`` axis (``parallel/mesh.py``),
and each phase runs slab by slab from one thread (launches are
asynchronous, so distinct cards overlap):

1. forward: every module of the model runs unchanged on each slab. A
   module that mixes X planes first gets ``r`` planes of its neighbours on
   each seam side (a halo), then its output loses the planes those touched:
   ``r = k // 2`` for the stem and each ConvNeXt block (the tail is
   pointwise) or each UNet3D conv, 1 coarse plane (2 fine ones) for the 2x
   upsample, 3 for the fixed dilation stack (3D once, in-plane twice), 0
   for the strided Downsample, the pools, the skip fusions and the heads.
   At the true volume ends a module keeps its own edge handling. This is
   XLA's halo exchange, not overlap-tile recompute. UNet3D's GroupNorm
   statistics are summed over every slab before any slab is normalised.
   Slab boundaries lie on multiples of ``2 ** k_down``, so every strided
   level splits cleanly; the slabs need not be equal.
2. connected components of bit 0: the flat padded index + 1 on the
   foreground (the reflect pad masked out), host-polled rounds of
   ``cc_propagates_per_round`` hops of the 26-connected masked max (the
   propagate kernel), each slab run ``Q`` hops at a time on itself plus a
   ``Q``-plane halo, so its interior is exact after every ``Q`` hops;
   axis sweeps (``_axis_run_max``) carry each X run's maximum across the
   seams, forward then back. Labels equal the unsharded schedule's after
   every round, so the round count, the cap and its warning are JAX's.
3. assignment: the N-step embedding walk of each gated voxel samples the
   vector field of the whole volume (``walk_gather='replicated'``: the
   bf16 field gathered onto each device; ``'ring'``: each step visits the
   other slabs in turn) and the final label lookup visits the label slabs
   in turn (``label_gather='ring'``) or a gathered copy (``'replicated'``).
   In ring mode no device holds a whole-volume label or vector tensor.

A sharded tensor is a :class:`Slabs`: per-device pieces in X order. The
mesh may repeat a device (``["cuda:0"] * 4``, ``["cpu"] * 4``), which runs
the multi-slab code on one device.
"""

from __future__ import annotations

import copy
import logging
import math
import os
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from skoots_tpu_torch.kernels.propagate import propagate
from skoots_tpu_torch.kernels.upsample import upsample2x
from skoots_tpu_torch.models.unext import UNet3D, UNeXT3D, activation, group_norm_apply
from skoots_tpu_torch.ops.flood_fill import _axis_run_max
from skoots_tpu_torch.ops.morphology import binary_dilation, binary_dilation_2d
from skoots_tpu_torch.ops.vec2embed import fma
from skoots_tpu_torch.parallel.mesh import split_to

log = logging.getLogger(__name__)

# the dilation stack of phase 1, fixed as JAX's (3D once, in-plane twice):
# the planes it reaches along X
DILATION_REACH = 3


def estimated_bytes_per_device(
    volume_shape: Tuple[int, int, int], n_space: int,
    walk_gather: str = "replicated", forward_bytes_per_voxel: int = 0,
) -> int:
    """Conservative per-device memory estimate for the sharded pipeline.

    ``walk_gather='replicated'``: each walk step indexes arbitrary positions
    of the vector field, so XLA all-gathers the f32 field (12 B/vox) onto
    every device; the device's own sharded slabs (vec bf16 + emb/index f32 +
    labels i32) add roughly another 30 B/vox / n_space.

    ``walk_gather='ring'``: nothing replicates — per shard the device holds
    its bf16 vec slab plus one visiting slab (2 x 6 B), the f32 embedding
    (12 B), i32 walk indices (12 B), two label slabs (8 B) and the output
    (4 B) ≈ 48 B/vox / n_space; 64 gives headroom for XLA transients.

    JAX's formulas, which leave the model forward out.
    ``forward_bytes_per_voxel`` adds the forward's own need, that many bytes
    a voxel of the device's slab (the engine measures it on a card; 0
    elsewhere, which gives JAX's estimate)."""
    x, y, z = volume_shape
    vox = x * y * z
    fwd = (int(forward_bytes_per_voxel) * vox) // max(1, n_space)
    if walk_gather == "ring":
        return (64 * vox) // max(1, n_space) + fwd
    return 12 * vox + (30 * vox) // max(1, n_space) + fwd


def device_bytes_limit(device=None) -> Optional[int]:
    """The memory this process can still allocate on ``device`` (default
    the first CUDA card): the card's free memory and the blocks the caching
    allocator holds unused. None off a card (CPU meshes), as JAX reports no
    limit there."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return torch.cuda.mem_get_info(device)[0] + cached


def resolve_spatial_shards(
    requested: Optional[int],
    n_devices: int,
    volume_shape: Tuple[int, int, int],
    bytes_limit: Optional[int] = None,
    forward_bytes_per_voxel: int = 0,
) -> int:
    """Pick the spatial shard count. ``requested=None`` means auto: use
    every device when more than one is present AND the volume fits the
    sharded pipeline's per-device memory ceiling — otherwise fall back to
    the host-streaming engine (0). Explicit values (0/1 = off) pass
    through untouched; the caller errors on an explicitly-requested but
    infeasible configuration rather than silently changing it."""
    if requested is not None:
        return requested
    if n_devices <= 1:
        return 0
    n = min(n_devices, max(1, volume_shape[0] // 8))
    if n <= 1:
        return 0
    if bytes_limit is not None:
        # the pipeline auto-degrades its phase-3 walk from replicated to
        # ring gathers when the field doesn't fit, so the fallback bar is
        # the RING estimate (everything O(vox/n)) — only volumes beyond
        # even that use the host-streaming engine
        need = estimated_bytes_per_device(volume_shape, n, "ring", forward_bytes_per_voxel)
        if need > bytes_limit:
            log.warning(
                "auto spatial sharding disabled: even the ring-gathered "
                "sharded pipeline needs ~%.1f GB/device for this volume "
                "but devices report %.1f GB; using the host-streaming "
                "engine (O(tile) memory) instead",
                need / 1e9, bytes_limit / 1e9,
            )
            return 0
    log.info(
        "auto spatial sharding: %d devices present -> sharding the "
        "volume's X axis %d-way (disable with --spatial-shards 0)",
        n_devices, n,
    )
    return n


# ------------------------------------------------------------------ slabs

class Slabs:
    """A tensor split along axis ``axis`` into contiguous pieces in order,
    each on its own device (``parts[i]`` holds the planes
    ``bounds[i][0]:bounds[i][1]``)."""

    def __init__(self, parts: List[torch.Tensor], axis: int = 0):
        self.parts = list(parts)
        self.axis = axis
        self.bounds = []
        lo = 0
        for p in self.parts:
            self.bounds.append((lo, lo + p.shape[axis]))
            lo += p.shape[axis]
        self.size = lo

    def map(self, fn) -> "Slabs":
        return Slabs([fn(p) for p in self.parts], self.axis)

    def gather(self, lo: int, hi: int, device) -> torch.Tensor:
        """The planes ``lo:hi`` on ``device``."""
        device = torch.device(device)
        pieces = []
        for p, (a, b) in zip(self.parts, self.bounds):
            s0, s1 = max(a, lo), min(b, hi)
            if s0 < s1:
                pieces.append(_to(p.narrow(self.axis, s0 - a, s1 - s0), device))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, self.axis)

    def whole(self, device=None) -> torch.Tensor:
        return self.gather(0, self.size, device or self.parts[0].device)


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=device.type == "cuda")


def slab_bounds(n_planes: int, n: int, quantum: int = 1) -> List[Tuple[int, int]]:
    """``n`` contiguous slabs of ``n_planes`` whose inner boundaries are
    multiples of ``quantum``, as equal as that allows (the first ones one
    quantum larger)."""
    blocks = -(-n_planes // quantum)
    if blocks < n:
        raise ValueError(
            f"{n_planes} planes make {blocks} blocks of {quantum} for {n} slabs; "
            f"shard at most {blocks} ways")
    per, extra = divmod(blocks, n)
    out, lo = [], 0
    for i in range(n):
        hi = min(n_planes, lo + (per + (i < extra)) * quantum)
        out.append((lo, hi))
        lo = hi
    return out


def _space_devices(mesh) -> List[torch.device]:
    """The devices of the mesh's first data row, one a slab (inference
    runs one volume: JAX replicates it over 'data')."""
    return list(mesh.devices[0])


def shard_volume(volume, mesh, spatial_axis: int = 1, bounds=None) -> Slabs:
    """Split ``volume`` (tensor or array) along ``spatial_axis`` into
    ``mesh.shape['space']`` slabs on the mesh's devices: at ``bounds``
    (``[(lo, hi), ...]``) when given, else as equal as possible."""
    if not torch.is_tensor(volume):
        volume = torch.from_numpy(np.ascontiguousarray(volume))
    devices = _space_devices(mesh)
    bounds = bounds or slab_bounds(volume.shape[spatial_axis], len(devices))
    return Slabs(split_to(volume, devices, spatial_axis, bounds), spatial_axis)


def _as_slabs(t, mesh, axis: int, bounds) -> Slabs:
    return t if isinstance(t, Slabs) else shard_volume(t, mesh, axis, bounds)


# ---------------------------------------------------------------- forward

def _halo_map(fn, s: Slabs, r: int) -> Slabs:
    """``fn`` on each slab extended by ``r`` planes of its neighbours on
    each seam side, then cropped back to the slab's own planes (scaled by
    the ratio of ``fn``'s output to input planes, 2 for the upsample)."""
    if r == 0 or len(s.parts) == 1:
        return s.map(fn)
    out = []
    for p, (lo, hi) in zip(s.parts, s.bounds):
        a, b = max(0, lo - r), min(s.size, hi + r)
        y = fn(s.gather(a, b, p.device))
        f = y.shape[s.axis] // (b - a)
        out.append(y.narrow(s.axis, (lo - a) * f, (hi - lo) * f))
    return Slabs(out, s.axis)


def _replicas(model, devices) -> dict:
    """The model on every device of the mesh, by device: the caller's
    module on its own device, a deep copy on each other one."""
    own = next(model.parameters()).device
    return {d: model if d == own else copy.deepcopy(model).to(d) for d in devices}


def _unext_forward(bb, x: Slabs) -> Slabs:
    """``UNeXT3D.forward`` (eval: no DropPath) over slabs; ``bb(t)`` is
    the backbone on ``t``'s device."""
    m0 = bb(x.parts[0])
    kd = m0.k_down

    def stage(x, name, depth):
        for i in range(depth):
            r = getattr(m0, f"{name}_block{i}").dwconv.weight.shape[0] // 2
            x = _halo_map(lambda t, i=i: getattr(bb(t), f"{name}_block{i}")(t), x, r)
        return x

    x = _halo_map(lambda t: bb(t).stem(t.to(m0.compute_dtype)), x,
                  m0.stem.weight.shape[0] // 2)
    skips = []
    for s in range(kd):
        x = stage(x, f"enc{s}", m0.depths[s])
        skips.append(x)
        x = x.map(lambda t, s=s: getattr(bb(t), f"down{s}")(t))
    x = stage(x, "bottleneck", m0.depths[kd])
    for s in range(kd):
        x = _halo_map(upsample2x, x, 1)
        skip = skips[kd - 1 - s]
        x = Slabs([getattr(bb(a), f"concat{s}")(a, b) for a, b in zip(x.parts, skip.parts)],
                  x.axis)
        x = stage(x, f"dec{s}", m0.depths[kd + 1 + s])
    return x.map(lambda t: bb(t).head(t))


def _group_norm(bb, name: str, x: Slabs) -> Slabs:
    """The GroupNorm ``name`` over slabs: each group's sum and sum of
    squares (f64) summed over every slab on the first device, then flax's
    statistics ``E[x]``, ``E[x^2] - E[x]^2`` (in f64, rounded to f32) and
    each slab normalised by them."""
    gn0 = getattr(bb(x.parts[0]), name)
    groups, c = gn0.groups, x.parts[0].shape[-1]
    dev0 = x.parts[0].device
    s1 = s2 = None
    count = 0
    for t in x.parts:
        g = t.float().reshape(t.shape[0], -1, groups, c // groups)
        a = _to(g.sum((1, 3), keepdim=True, dtype=torch.float64), dev0)
        b = _to(g.square().sum((1, 3), keepdim=True, dtype=torch.float64), dev0)
        s1 = a if s1 is None else s1 + a
        s2 = b if s2 is None else s2 + b
        count += g.shape[1] * g.shape[3]
    mean = s1 / count
    var = (s2 / count - mean.square()).clamp_min(0.0)
    mean, var = mean.float(), var.float()

    def apply(t):
        gn = getattr(bb(t), name)
        return group_norm_apply(t, _to(mean, t.device), _to(var, t.device), gn.weight,
                                gn.bias, groups, gn.compute_dtype)

    return x.map(apply)


def _unet_forward(bb, x: Slabs) -> Slabs:
    """``UNet3D.forward`` over slabs (``bb`` as in :func:`_unext_forward`)."""
    m0 = bb(x.parts[0])
    kd, dt = m0.k_down, m0.compute_dtype

    def stage(x, name, depth):
        for i in range(depth):
            r = getattr(m0, f"{name}_conv{i}").weight.shape[0] // 2
            x = _halo_map(lambda t, i=i: getattr(bb(t), f"{name}_conv{i}")(t), x, r)
            x = _group_norm(bb, f"{name}_gn{i}", x)
            x = x.map(lambda t: activation(m0.activation, t, dt))
        return x

    x = x.map(lambda t: t.to(dt))
    skips = []
    for s in range(kd):
        x = stage(x, f"enc{s}", m0.depths[s])
        skips.append(x)
        x = x.map(UNet3D.pool)
    x = stage(x, "bottleneck", m0.depths[kd])
    for s in range(kd):
        x = _halo_map(upsample2x, x, 1)
        skip = skips[kd - 1 - s]
        x = Slabs([torch.cat([a, b.to(a.dtype)], dim=-1) for a, b in zip(x.parts, skip.parts)],
                  x.axis)
        x = stage(x, f"dec{s}", m0.depths[kd + 1 + s])
    return x.map(lambda t: bb(t).head(t))


def _slab_quantum(model) -> int:
    return 2 ** model.backbone.k_down


def make_sharded_forward(
    model,
    mesh,
    prob_threshold: float = 0.8,
    spatial_axis: int = 1,
    semantic_threshold: float | None = None,
):
    """Phase 1 with the volume sharded over the mesh's 'space' axis.

    Returns ``fwd(volume, mean, std) -> (vec, packed)``: ``volume`` the
    raw ``[X, Y, Z]`` volume as :class:`Slabs` (or a tensor / array, split
    at multiples of ``2 ** k_down``); ``vec`` bf16 ``[x, Y, Z, 3]`` and
    ``packed`` uint8 ``[x, Y, Z]`` slabs. ``packed`` is bit-packed: bit 0 =
    dilated thresholded skeleton (the CC input), bit 1 = semantic
    foreground (prob > threshold, un-dilated) — the assign-phase gate uses
    the actual probability decision, not vector non-zeroness.
    ``spatial_axis`` must be 1 (X of ``[B, X, Y, Z, C]``), the only axis
    the port shards. ``model`` is the port's ``SpatialEmbedding`` (UNeXT3D
    or UNet3D backbone); it is copied to each other device of the mesh."""
    if spatial_axis != 1:
        raise ValueError(f"spatial_axis {spatial_axis}: the port shards X (axis 1) only")
    if not isinstance(model.backbone, (UNeXT3D, UNet3D)):
        raise TypeError(f"no sharded forward for {type(model.backbone).__name__}")
    sem_thr = prob_threshold if semantic_threshold is None else semantic_threshold
    devices = _space_devices(mesh)
    replicas = _replicas(model, devices)
    walk = _unext_forward if isinstance(model.backbone, UNeXT3D) else _unet_forward
    quantum = _slab_quantum(model)

    def bb(t):
        return replicas[t.device].backbone

    @torch.no_grad()
    def outputs(x: Slabs) -> Slabs:
        """The model's f32 ``[1, x, Y, Z, 5]`` output slabs from normalised
        ``[1, x, Y, Z, 1]`` input slabs (``axis`` 1)."""
        return walk(bb, x).map(lambda t: replicas[t.device].heads(t))

    @torch.no_grad()
    def fwd(volume, mean, std):
        if not isinstance(volume, Slabs):
            n = volume.shape[0]
            volume = shard_volume(volume, mesh, 0, slab_bounds(n, len(devices), quantum))
        x = Slabs([((t.float() - float(mean)) / float(std))[None, ..., None]
                   for t in volume.parts], 1)
        out = outputs(x)
        vec, skel, sem = [], [], []
        for o in out.parts:
            prob = o[..., 4:5]
            keep = (prob > prob_threshold).to(o.dtype)
            vec.append((o[..., 0:3] * keep)[0].to(torch.bfloat16))
            skel.append(o[..., 3:4] * keep)
            sem.append((prob[0, ..., 0] > sem_thr).to(torch.uint8))
        del out
        skel = _halo_map(lambda t: binary_dilation_2d(binary_dilation_2d(binary_dilation(t))),
                         Slabs(skel, 1), DILATION_REACH)
        packed = [(s[0, ..., 0] > prob_threshold).to(torch.uint8) | (m << 1)
                  for s, m in zip(skel.parts, sem)]
        return Slabs(vec, 0), Slabs(packed, 0)

    fwd.quantum, fwd.outputs = quantum, outputs
    return fwd


# ----------------------------------------------------------------- assign

def _coords(sel: torch.Tensor, lo: int, ny: int, nz: int) -> torch.Tensor:
    """f32 ``[len(sel), 3]`` global coordinates of a slab's flat indices."""
    r = sel % (ny * nz)
    return torch.stack([sel // (ny * nz) + lo, r // nz, r % nz], -1).float()


def _ring_lookup(slabs: Slabs, me: int, ix, iy, iz, init) -> torch.Tensor:
    """``slabs[ix, iy, iz]`` for global X indices ``ix``, visiting the
    slabs in ring order from ``me``: each contributes where it owns ``ix``
    (two slabs are resident at a time)."""
    res = init
    n = len(slabs.parts)
    dev = ix.device
    for s in range(n):
        owner = (me + s) % n
        lo, hi = slabs.bounds[owner]
        blk = _to(slabs.parts[owner], dev)
        ok = (ix >= lo) & (ix < hi)
        vals = blk[(ix - lo).clamp(0, hi - lo - 1), iy, iz]
        if vals.dim() > ok.dim():
            ok = ok[..., None]
        res = torch.where(ok, vals.to(res.dtype), res)
    return res


def _walk(v0: torch.Tensor, coords: torch.Tensor, scale: torch.Tensor, steps: int,
          extents, sample) -> torch.Tensor:
    """The embedding walk of ``vector_to_embedding`` (decay 1) for the
    voxels at ``coords`` with vectors ``v0``: ``steps`` re-samples at the
    rounded position clipped to ``extents``; each ``p + v * scale`` one
    fused multiply-add. Returns the f32 embeddings."""
    embed = fma(v0, scale, coords)
    hi = torch.tensor(extents, dtype=torch.int64, device=coords.device) - 1
    for _ in range(steps):
        idx = torch.round(embed).to(torch.int64).clamp(min=torch.zeros_like(hi), max=hi)
        embed = fma(sample(idx[:, 0], idx[:, 1], idx[:, 2]), scale, embed)
    return embed


def _final_index(embed: torch.Tensor, extents):
    idx = torch.round(embed).to(torch.int64)
    return tuple(idx[:, a].clamp(0, extents[a] - 1) for a in range(3))


def _gathered_by_device(s: Slabs, dtype=None):
    """``get(device)``: the whole of ``s`` on that device, gathered once
    a device."""
    cache = {}

    def get(device):
        if device not in cache:
            w = s.whole(device)
            cache[device] = w if dtype is None else w.to(dtype)
        return cache[device]

    return get


def make_sharded_assign(
    mesh,
    vector_scale: Sequence[float],
    embed_iterations: int = 10,
    spatial_axis: int = 1,
    label_gather: str = "ring",
):
    """Phase 3 with the vector field sharded over 'space'.

    Returns ``assign(labels, vec) -> int32 [x, Y, Z] slabs``: ``vec`` the
    f32 field ``[X, Y, Z, 3]`` as :class:`Slabs` (or a tensor, also
    ``[1, X, Y, Z, 3]``); ``labels`` int32 ``[X, Y, Z]`` (a tensor, or
    slabs). The N-step walk samples the vector field across the WHOLE
    volume (gathered onto each device), indices clipped to the field; the
    final lookup clips to the labels' extents; voxels whose vector is all
    zero get 0.

    label_gather:
        'replicated' — every device holds the full labeled-skeleton volume.
        'ring' — labels stay X-sharded (split as ``vec`` is); each device
            visits the label slabs in turn and picks up the values its
            embedded indices own (two slabs resident at a time).
    """
    if spatial_axis != 1:
        raise ValueError(f"spatial_axis {spatial_axis}: the port shards X (axis 1) only")
    n_space = mesh.shape["space"]
    steps = int(embed_iterations) - 1

    @torch.no_grad()
    def assign(labels, vec):
        if torch.is_tensor(vec) and vec.dim() == 5:
            vec = vec[0]
        vec = _as_slabs(vec, mesh, 0, None)
        shape = tuple(vec.parts[0].shape[1:3])
        lab_shape = (vec.size, *shape) if isinstance(labels, Slabs) else tuple(labels.shape)
        ring = label_gather == "ring" and n_space > 1
        if ring:
            labels = _as_slabs(labels, mesh, 0, vec.bounds)
        elif isinstance(labels, Slabs):
            labels = labels.whole()
        field = _gathered_by_device(vec, torch.float32)
        out = []
        for i, (v, (lo, hi)) in enumerate(zip(vec.parts, vec.bounds)):
            dev = v.device
            scale = torch.as_tensor(vector_scale, dtype=torch.float32, device=dev)
            vf = v.float().reshape(-1, 3)
            sel = torch.nonzero((vf != 0).any(-1)).squeeze(1)
            full = field(dev)
            emb = _walk(vf[sel], _coords(sel, lo, *shape), scale, steps,
                        (vec.size, *shape), lambda a, b, c: full[a, b, c])
            ix, iy, iz = _final_index(emb, lab_shape)
            if ring:
                inst = _ring_lookup(labels, i, ix, iy, iz,
                                    torch.zeros(ix.shape, dtype=torch.int32, device=dev))
            else:
                inst = _to(labels, dev)[ix, iy, iz]
            o = torch.zeros(vf.shape[0], dtype=torch.int32, device=dev)
            o[sel] = inst.to(torch.int32)
            out.append(o.view(hi - lo, *shape))
        return Slabs(out, 0)

    return assign


# --------------------------------------------------------------- pipeline

def _sync(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def make_sharded_pipeline(
    model,
    mesh,
    volume_shape: Tuple[int, int, int],
    vector_scale: Sequence[float] = (60.0, 60.0, 12.0),
    prob_threshold: float = 0.8,
    embed_iterations: int = 10,
    cc_rounds: int = 32,
    cc_propagates_per_round: int = 128,
    cc_scans_per_round: int = 0,
    label_gather: str = "ring",
    walk_gather: str = "auto",
    semantic_threshold: float | None = None,
):
    """Full volume -> instance labels over the mesh's 'space' axis.

    The multi-device counterpart of the whole-volume pipeline: one sharded
    forward over the whole (padded) volume, sharded connected components of
    the skeleton map (propagate-only label relaxation, with axis sweeps when
    ``cc_scans_per_round`` or ``SKOOTS_CC_SCANS`` asks; no pointer jumps, so
    labels never replicate), and a sharded N-step embedding walk whose final
    label lookup visits the label slabs in turn (``label_gather='ring'``,
    the default) or a gathered copy (``'replicated'``).

    The volume is reflect-padded as JAX's: X to a multiple of
    ``lcm(4, n)``, Y and Z to multiples of 4. The CC's host polls the
    ``changed`` flag after each round of ``cc_propagates_per_round`` hops
    until the fixpoint, up to ``max(cc_rounds * P, 4 * (px + py + pz))``
    hops, and warns (``RuntimeWarning``) at that cap.

    ``walk_gather``: ``'replicated'`` gathers the bf16 vector field onto
    each device once; ``'ring'`` keeps it X-sharded and visits the other
    slabs once a walk step; ``'auto'`` (default) picks 'replicated' when
    JAX's replicated estimate fits the first device's free memory and
    'ring' otherwise (and 'replicated' off a card). 'ring' needs
    ``label_gather='ring'``.

    Returns ``run(volume [X, Y, Z] array or tensor, mean, std) -> np.int32
    labels [X, Y, Z]`` (unique but non-sequential). The stages are
    ``run.fwd`` (:func:`make_sharded_forward`), ``run.cc(packed) -> int32
    label slabs`` (``packed`` uint8 ``[px, py, pz]`` slabs or a tensor;
    ``run.cc.last_rounds``, ``last_converged``, ``hop_chunks``: the hops of
    each halo exchange in a round) and ``run.assign(labels, vec, packed) ->
    int32 slabs``; ``run.bounds`` is the slab layout of the padded X axis,
    ``run.padded_shape`` the padded shape, ``run.last_phase_s`` the
    ``fwd`` / ``cc`` / ``assign`` seconds of the last call.
    """
    x, y, z = volume_shape
    devices = _space_devices(mesh)
    n_space = mesh.shape["space"]
    if walk_gather == "auto":
        limit = device_bytes_limit(devices[0])
        if (n_space > 1 and label_gather != "replicated"
                and limit is not None
                and estimated_bytes_per_device(volume_shape, n_space) > limit):
            log.info(
                "walk_gather auto -> ring: replicated walk needs ~%.1f "
                "GB/device, devices report %.1f GB",
                estimated_bytes_per_device(volume_shape, n_space) / 1e9,
                limit / 1e9,
            )
            walk_gather = "ring"
        else:
            walk_gather = "replicated"
    if walk_gather == "ring" and label_gather == "replicated":
        raise ValueError(
            "walk_gather='ring' requires sharded labels "
            "(label_gather='ring')"
        )
    # padded dims: divisible by 4 (model downsampling); X also by the shard
    # count, as JAX's (the pad's content reaches the real edge voxels)
    mx = math.lcm(4, n_space)
    px = -(-x // mx) * mx
    py = -(-y // 4) * 4
    pz = -(-z // 4) * 4
    if px * py * pz >= 2**31:
        raise ValueError("volume too large for int32 voxel addresses")
    pads = ((0, px - x), (0, py - y), (0, pz - z))
    fwd = make_sharded_forward(model, mesh, prob_threshold,
                               semantic_threshold=semantic_threshold)
    bounds = slab_bounds(px, n_space, fwd.quantum)
    prop = int(cc_propagates_per_round)
    # hops between halo exchanges: half the thinnest slab (a chunk runs on
    # its slab and Q planes each side); one slab has no seam to exchange
    q = prop if n_space == 1 else max(1, min(prop, min(hi - lo for lo, hi in bounds) // 2))
    hop_chunks = [q] * (prop // q) + ([prop % q] if prop % q else [])
    steps = int(embed_iterations) - 1

    def _x_run_max(lab: List[torch.Tensor], fg: List[torch.Tensor]) -> List[torch.Tensor]:
        """``_axis_run_max`` along X over the slabs: a forward pass carrying
        each run's maximum so far into the next slab, then a backward pass
        carrying the run's maximum back (exact: max is associative)."""
        n = len(lab)
        fwd_pass, carry = [], None
        for t, f in zip(lab, fg):
            if carry is None:
                r = _axis_run_max(t, f, 0)
            else:
                r = _axis_run_max(torch.cat([_to(carry[0], t.device), t]),
                                  torch.cat([_to(carry[1], t.device), f]), 0)[1:]
            fwd_pass.append(r)
            carry = (r[-1:], f[-1:])
        out, carry = [None] * n, None
        for i in reversed(range(n)):
            t, f = fwd_pass[i], fg[i]
            if carry is None:
                r = t
            else:
                r = _axis_run_max(torch.cat([t, _to(carry[0], t.device)]),
                                  torch.cat([f, _to(carry[1], t.device)]), 0)[:-1]
            out[i] = r
            carry = (r[:1], f[:1])
        return out

    def _hops(lab: Slabs, fg: Slabs, fg_ext: dict, passes: int) -> Slabs:
        """``passes`` propagation hops, each slab on itself plus a
        ``passes``-plane halo of its neighbours' labels, then cropped."""
        out = []
        for i, (p, (lo, hi)) in enumerate(zip(lab.parts, lab.bounds)):
            a, b = max(0, lo - passes), min(px, hi + passes)
            if (a, b) == (lo, hi):
                out.append(propagate(p, fg.parts[i], passes=passes))
                continue
            if (i, passes) not in fg_ext:
                fg_ext[i, passes] = fg.gather(a, b, p.device)
            res = propagate(lab.gather(a, b, p.device), fg_ext[i, passes], passes=passes)
            out.append(res.narrow(0, lo - a, hi - lo))
        return Slabs(out, 0)

    def _cc_init(skel: Slabs):
        labs, fgs = [], []
        for t, (lo, hi) in zip(skel.parts, skel.bounds):
            dev = t.device
            gx = torch.arange(lo, hi, device=dev, dtype=torch.int32).view(-1, 1, 1)
            gy = torch.arange(py, device=dev, dtype=torch.int32).view(1, -1, 1)
            gz = torch.arange(pz, device=dev, dtype=torch.int32).view(1, 1, -1)
            # reflect-padded mirror skeletons must not seed/merge labels
            fg = ((t & 1) > 0) & (gx < x) & (gy < y) & (gz < z)
            flat = gx * (py * pz) + gy * pz + gz
            labs.append(torch.where(fg, flat + 1, 0).to(torch.int32))
            fgs.append(fg.to(torch.uint8))
        return Slabs(labs, 0), Slabs(fgs, 0)

    @torch.no_grad()
    def cc(skel):
        """Label the sharded skeleton (bit 0 of ``skel``) to convergence;
        the labels stay sharded. Warns — loudly — if the cap is hit before
        the fixpoint."""
        skel = _as_slabs(skel, mesh, 0, bounds)
        labels, fg = _cc_init(skel)
        n_scans = int(os.environ.get("SKOOTS_CC_SCANS", cc_scans_per_round))
        # reach needed ~= longest geodesic skeleton path. Bound it by the
        # Manhattan diameter x4 (tortuosity allowance); never below the
        # caller's explicit cc_rounds * propagates budget.
        max_hops = max(cc_rounds * prop, 4 * (px + py + pz))
        max_dispatches = -(-max_hops // prop)
        fg_ext: dict = {}
        converged = False
        rounds = 0
        for _ in range(max_dispatches):
            orig = labels
            lab = labels.parts
            for _ in range(n_scans):
                lab = _x_run_max(lab, fg.parts)
                lab = [_axis_run_max(_axis_run_max(t, f, 1), f, 2)
                       for t, f in zip(lab, fg.parts)]
            labels = Slabs(lab, 0)
            for q in hop_chunks:
                labels = _hops(labels, fg, fg_ext, q)
            rounds += 1
            # convergence is judged against the PRE-scan labels: a round whose
            # only progress came from the scans still counts as changed
            flags = [_to((a != b).any(), orig.parts[0].device)
                     for a, b in zip(labels.parts, orig.parts)]
            if not bool(torch.stack(flags).any()):
                converged = True
                break
        cc.last_rounds, cc.last_converged = rounds, converged
        if not converged:
            warnings.warn(
                "sharded CC hit its round cap before convergence "
                f"({max_dispatches} dispatches x {prop} "
                "hops); some instances may be split. Raise cc_rounds or "
                "cc_propagates_per_round.",
                RuntimeWarning,
            )
        return labels

    cc.last_rounds = cc.last_converged = None
    cc.hop_chunks = hop_chunks

    @torch.no_grad()
    def assign(labels, vec, skel):
        """The walk and the label lookup of every voxel whose bit 1 is set;
        intermediate walk indices clip to the padded extents, the final
        lookup to the real ones."""
        vec = _as_slabs(vec, mesh, 0, bounds)
        skel = _as_slabs(skel, mesh, 0, bounds)
        labels = _as_slabs(labels, mesh, 0, bounds)
        lab_whole = _gathered_by_device(labels)
        vec_whole = _gathered_by_device(vec)
        out = []
        for i, (v, g, (lo, hi)) in enumerate(zip(vec.parts, skel.parts, vec.bounds)):
            dev = v.device
            scale = torch.as_tensor(vector_scale, dtype=torch.float32, device=dev)
            sel = torch.nonzero(((g >> 1) > 0).reshape(-1)).squeeze(1)
            v0 = v.reshape(-1, 3)[sel].float()
            if walk_gather == "ring":
                def sample(a, b, c, i=i, dev=dev):
                    init = torch.zeros((a.shape[0], 3), dtype=torch.float32, device=dev)
                    return _ring_lookup(vec, i, a, b, c, init)
            else:
                full = vec_whole(dev)

                def sample(a, b, c, full=full):
                    return full[a, b, c].float()
            emb = _walk(v0, _coords(sel, lo, py, pz), scale, steps, (px, py, pz), sample)
            # the final lookup clamps into the REAL region: walks that leave
            # the volume land on the nearest in-bounds voxel, never the pad
            ix, iy, iz = _final_index(emb, (x, y, z))
            if label_gather == "ring":
                inst = _ring_lookup(labels, i, ix, iy, iz,
                                    torch.zeros(ix.shape, dtype=torch.int32, device=dev))
            else:
                inst = lab_whole(dev)[ix, iy, iz]
            o = torch.zeros((hi - lo) * py * pz, dtype=torch.int32, device=dev)
            o[sel] = inst
            out.append(o.view(hi - lo, py, pz))
        return Slabs(out, 0)

    def run(volume, mean, std):
        run.last_phase_s = {}
        vol = np.pad(np.asarray(volume, np.float32), pads, mode="reflect")
        _sync(devices)
        t0 = time.time()

        def mark(tag):
            nonlocal t0
            _sync(devices)
            t1 = time.time()
            run.last_phase_s[tag] = round(t1 - t0, 3)
            t0 = t1

        vec, packed = fwd(shard_volume(vol, mesh, 0, bounds), mean, std)
        mark("fwd")
        labels = cc(packed)
        mark("cc")
        inst = assign(labels, vec, packed)
        mark("assign")
        return inst.whole("cpu").numpy()[:x, :y, :z]

    run.fwd, run.cc, run.assign = fwd, cc, assign
    run.bounds, run.padded_shape = bounds, (px, py, pz)
    run.walk_gather = walk_gather
    run.last_phase_s = {}
    return run
