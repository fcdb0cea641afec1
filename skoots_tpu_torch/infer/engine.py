"""End-to-end SKOOTS inference: the ``skoots --image`` path.

Port of ``skoots_tpu/infer/engine.py::run_inference`` with both of its
single-device engines:

* the **host-streaming engine** (``engine.py:716-1256``), which ``auto``
  picks for volumes of 256^3 voxels or fewer, for a phase-1 cache
  (``--use-cached``), for ``out_of_core=True``, and when the whole volume
  does not fit the device:

  1. a pipelined tile sweep (read-ahead thread; dispatch tile t, then drain
     tile t-1) runs the model and writes f16 vectors and the dilated
     skeleton and semantic masks (bit-packed on the wire) into host
     buffers, memmapped when out of core, cached as
     ``<image>_skoots_{vectors,skeleton,semantic}.npy`` with the
     ``_skoots_phase1.json`` sidecar of the knobs baked into them;
  2. tiled connected components with a host seam union-find
     (``ops/flood_fill.py::efficient_flood_fill``);
  3. per assign tile, the embedding walk on the device (from the stored
     vectors, or the forward run again in ``wire_mode='recompute'``), then
     a label gather from just the label crop the walks reach (or x-slabs of
     the labels past ``label_crop_budget_bytes``);

* the **whole-volume device pipeline** (``infer/device_pipeline.py``), in
  its chunked form or its device-thrifty one (native-dtype volume, no
  vector buffer, 16-bit labels), which ``auto`` picks where only the
  thrifty estimate fits the card.

Both drop speck instances, renumber, and write ``<image>_instance_mask.tif``
(``.npy`` for a ``.npy`` image, or ``output_path``), ``<image>_skoots_benchmark.txt`` and
``<image>_skoots_phases.json`` (the stage split). A sparse checkpoint's
semantic gate comes from a probe of the volume itself
(:func:`_probe_semantic_threshold`), else from the threshold the checkpoint
records, else ``prob_threshold``.

``spatial_shards > 1`` (or ``None``, auto, with several devices) runs the
sharded pipeline (``infer/sharded.py``) over that many of the call's
devices instead: ``device`` may be a list (entries may repeat, e.g.
``["cpu"] * 4``), and a single CUDA device means every visible card.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time
import tracemalloc
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.infer.autoknobs import (
    REFERENCE_STACK,
    calibrate_semantic_threshold_from_histogram,
    derive_dilation,
    estimate_skeleton_gap,
)
from skoots_tpu_torch.infer.device_pipeline import (
    estimated_device_bytes,
    make_chunked_pipeline,
    make_thrifty_pipeline,
    tile_masks,
)
from skoots_tpu_torch.infer import sharded
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.ops.cropper import (
    bucketed_crop_size,
    bucketed_crop_size_down,
    crop_origins,
)
from skoots_tpu_torch.ops.flood_fill import (
    drop_small_instances,
    efficient_flood_fill,
    renumber,
    renumber_inplace,
    widen_u16,
)
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.parallel import make_mesh
from skoots_tpu_torch.utils.device import resolve_devices
from skoots_tpu_torch.utils.io import imread, imsave, open_outofcore

log = logging.getLogger(__name__)

# the stage split of the most recent run_inference call (also written to
# <image>_skoots_phases.json)
last_stats: dict = {}

# the forward probe that sizes a slab's activations for the sharded estimate
FORWARD_PROBE = (128, 128, 64)
# what the caching allocator reserves for each byte a slab's forward holds at
# once: whole-slab activations of several sizes split and round its segments
# (an H100 80GB HBM3 at its 700 W limit reserved 1.25-1.64x the live peak
# at 1-4 slabs of a 254x256x256 volume)
RESERVED_PER_LIVE_BYTE = 2

# 'auto' takes the host-streaming engine up to this many voxels
HOST_ENGINE_MAX_VOXELS = 256**3
# the whole-volume pipelines address voxels with int32 (their CC raises at
# 2^31 voxels, ``ops/flood_fill.py``); the host engine's CC works per tile
DEVICE_ENGINE_MAX_VOXELS = 2**31 - 1


def _pad_amounts(dim: int, crop: int, ov: int) -> Tuple[int, int]:
    """Reflect-pad so tile interiors [ov, padded-ov) cover [0, dim)."""
    return ov, max(ov, crop - (dim + ov))


def _read_tile(volume: np.ndarray, origin, crop, pads) -> np.ndarray:
    """One padded-coordinate tile of the unpadded (possibly memmapped)
    volume, reflect-padding only the tile edges."""
    src, tile_pads = [], []
    for ax in range(3):
        start = origin[ax] - pads[ax][0]
        end = start + crop[ax]
        dim = volume.shape[ax]
        src.append(slice(max(0, start), min(dim, end)))
        tile_pads.append((max(0, -start), max(0, end - dim)))
    tile = np.asarray(volume[tuple(src)])
    if any(p != (0, 0) for p in tile_pads):
        tile = np.pad(tile, tile_pads + [(0, 0)] * (volume.ndim - 3),
                      mode="reflect")
    return tile


def _pack_bits(m: torch.Tensor) -> torch.Tensor:
    """``[..., Z]`` {0, 1} -> ``[..., Z // 8]`` uint8 in ``np.packbits``'s
    big-endian layout: the phase-1 masks cross the device -> host wire at
    one bit per voxel."""
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                     device=m.device)
    b = m.reshape(*m.shape[:-1], m.shape[-1] // 8, 8).to(torch.int32)
    return (b * w).sum(-1).to(torch.uint8)


def _make_mask_decoder(z: int):
    """Host inverse of :func:`_pack_bits` for a ``[B, X, Y, Z // 8]`` batch."""

    def decode(t: np.ndarray) -> np.ndarray:
        return np.unpackbits(t, axis=-1)[..., :z]

    return decode


def _to_host(tensors, device: torch.device):
    """Start the device -> host copies of ``tensors``: on a card into pinned
    memory without blocking, with an event to wait on (:func:`_host_arrays`)."""
    if device.type != "cuda":
        return tuple(t.cpu() for t in tensors), None
    host = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_arrays(pending) -> list:
    host, done = pending
    if done is not None:
        done.synchronize()
    return [h.numpy() for h in host]


def _upload(a, device: torch.device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, non_blocking=True)


def _make_tile_fn(model, mean, std, prob_thr: float, dilation_3d: int = 1,
                  dilation_2d: int = 2, sem_thr: float | None = None,
                  store_vectors: bool = True, pack_wire: bool = False,
                  device=None):
    """Phase-1 tile step: ``[B, X, Y, Z, 1]`` image tiles of any dtype
    (normalised on the device, so a uint8 volume crosses the wire at one
    byte per voxel) -> the started host copies of (f16 vectors unless
    ``store_vectors`` is off, dilated-skeleton mask, semantic mask), each
    mask uint8 ``[B, X, Y, Z]``, or bit-packed ``[B, X, Y, Z // 8]`` with
    ``pack_wire``. The decisions are ``device_pipeline.tile_masks``'s."""
    sem_thr = prob_thr if sem_thr is None else sem_thr
    device = torch.device(device)

    @torch.no_grad()
    def tile_fn(image_tiles) -> tuple:
        x = (_upload(image_tiles, device).float() - mean) / std
        vec, skel_u8, sem_u8 = tile_masks(model(x), prob_thr, sem_thr,
                                          dilation_3d, dilation_2d)
        if pack_wire:
            skel_u8, sem_u8 = _pack_bits(skel_u8), _pack_bits(sem_u8)
        outs = (skel_u8, sem_u8)
        if store_vectors:
            outs = (vec.to(torch.float16),) + outs
        return _to_host(outs, device)

    return tile_fn


def _walk_indices(scale, vec: torch.Tensor, offsets, vol_shape, n_iter: int,
                  decay: float, exit_fraction, exit_cycle: bool):
    """Walk the embedding of f32 vectors ``[B, X, Y, Z, 3]``, shift it by
    each tile's volume offset and round: clipped int32 volume indices and
    their per-axis min and max."""
    dev = vec.device
    emb = vector_to_embedding(scale, vec, n=n_iter, decay=decay,
                              exit_fraction=exit_fraction, exit_cycle=exit_cycle)
    emb = emb + _upload(offsets, dev)[:, None, None, None, :]
    dims = torch.tensor(vol_shape, dtype=torch.int32, device=dev)
    idx = torch.round(emb).to(torch.int32).clamp(min=torch.zeros_like(dims),
                                                max=dims - 1)
    return idx, idx.amin(dim=(0, 1, 2, 3)), idx.amax(dim=(0, 1, 2, 3))


def _make_embed_fn(scale: Sequence[float], vol_shape: Tuple[int, int, int],
                   n_iter: int, decay: float = 1.0,
                   exit_fraction: float | None = None,
                   exit_cycle: bool = False, device=None):
    """Phase-3a step from stored vectors: ``(f16 vector tiles, offsets
    [B, 3]) -> (idx, mins, maxs)``; the indices stay on the device, only
    the 6 bbox scalars cross to the host."""
    device = torch.device(device)

    @torch.no_grad()
    def embed_fn(vec_tiles, offsets):
        vec = _upload(vec_tiles, device).float()
        return _walk_indices(scale, vec, offsets, vol_shape, n_iter, decay,
                             exit_fraction, exit_cycle)

    return embed_fn


def _make_recompute_embed_fn(model, mean, std, prob_thr: float,
                             sem_thr: float | None, scale: Sequence[float],
                             vol_shape: Tuple[int, int, int], n_iter: int,
                             decay: float = 1.0,
                             exit_fraction: float | None = None,
                             exit_cycle: bool = False, device=None):
    """Phase-3a step for ``wire_mode='recompute'``: raw image tiles -> the
    forward again, the gated vectors rounded to f16 as phase 1 stores them,
    the walk, and the semantic gate (all ones when ``sem_thr`` is None):
    ``(idx, fg, mins, maxs)``."""
    device = torch.device(device)

    @torch.no_grad()
    def rec_fn(image_tiles, offsets):
        out = model((_upload(image_tiles, device).float() - mean) / std)
        vec, prob = out[..., 0:3], out[..., 4:5]
        keep = (prob > prob_thr).to(out.dtype)
        vec = (vec * keep).to(torch.float16).float()
        idx, mins, maxs = _walk_indices(scale, vec, offsets, vol_shape, n_iter,
                                        decay, exit_fraction, exit_cycle)
        if sem_thr is None:
            fg = torch.ones(prob.shape[:-1], dtype=torch.uint8, device=device)
        else:
            fg = (prob[..., 0] > sem_thr).to(torch.uint8)
        return idx, fg, mins, maxs

    return rec_fn


def _gather_ids(labels_crop: torch.Tensor, idx: torch.Tensor, origin,
                fg: torch.Tensor) -> torch.Tensor:
    """Phase-3b: instance ids from a label SUB-volume at ``origin``, gated
    by the semantic mask (the clip guards the bbox's bucket padding)."""
    rel = idx - torch.tensor(origin, dtype=torch.int32, device=idx.device)
    dims = torch.tensor(labels_crop.shape, dtype=torch.int32, device=idx.device)
    rel = rel.clamp(min=torch.zeros_like(dims), max=dims - 1).long()
    inst = labels_crop[rel[..., 0], rel[..., 1], rel[..., 2]]
    return torch.where(fg > 0, inst, 0)


def _gather_ids_slab(labels_slab: torch.Tensor, idx: torch.Tensor, x0: int,
                     fg: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Phase-3b, streamed: gather from ONE full-y/z x-slab of the labels
    starting at ``x0``, accumulating into ``acc`` across slabs."""
    relx = idx[..., 0] - x0
    depth = labels_slab.shape[0]
    inb = (relx >= 0) & (relx < depth)
    rx = relx.clamp(0, depth - 1).long()
    inst = labels_slab[rx, idx[..., 1].long(), idx[..., 2].long()]
    return torch.where(inb & (fg > 0), inst, acc)


def _bucket_bbox(mins, maxs, vol_shape, quantum=(64, 64, 16)):
    """Round a bbox up to quantized shapes and clamp it inside the volume.
    Returns (origin, shape) int tuples."""
    origin, shape = [], []
    for ax in range(3):
        lo, hi = int(mins[ax]), int(maxs[ax]) + 1
        dim, q = vol_shape[ax], quantum[ax]
        size = min(dim, ((hi - lo + q - 1) // q) * q)
        origin.append(max(0, min(lo, dim - size)))
        shape.append(size)
    return tuple(origin), tuple(shape)


def _sweep(volume: np.ndarray, writers, tile_fn, crop, overlap, batch: int,
           desc: str, times: Optional[dict] = None, pin: bool = False):
    """Pipelined tile sweep: a read-ahead thread gathers batch t+1 while
    batch t is dispatched and batch t-1 drained. ``writers`` are arrays or
    ``(array, decode)`` pairs receiving the interiors of ``tile_fn``'s
    outputs, in order. ``times`` receives ``gather_s`` (waiting for the
    read-ahead), ``dispatch_s`` (``tile_fn``; on a card the kernels are
    queued, not finished) and ``drain_s`` (waiting for the device -> host
    copies + interior writes)."""
    spatial = volume.shape[:3]
    pads = [_pad_amounts(d, c, o) for d, c, o in zip(spatial, crop, overlap)]
    padded_shape = tuple(d + p[0] + p[1] for d, p in zip(spatial, pads))
    origins = crop_origins(padded_shape, crop, overlap)

    def padded_batch(bi):
        batch_origins = origins[bi * batch:(bi + 1) * batch]
        real = len(batch_origins)
        batch_origins = batch_origins + [batch_origins[-1]] * (batch - real)
        return batch_origins, real

    def gather_batch(batch_origins):
        t = torch.from_numpy(np.stack([_read_tile(volume, o, crop, pads)
                                       for o in batch_origins]))
        return t.pin_memory() if pin else t

    pending = None  # (started host copies, batch origins)
    t0 = time.time()
    tg = td = tw = 0.0
    n_batches = (len(origins) + batch - 1) // batch
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(gather_batch, padded_batch(0)[0]) if n_batches else None
        for bi in range(n_batches):
            batch_origins, real = padded_batch(bi)
            ts = time.time()
            tiles = fut.result()
            if bi + 1 < n_batches:
                fut = ex.submit(gather_batch, padded_batch(bi + 1)[0])
            tg += time.time() - ts
            ts = time.time()
            results = tile_fn(tiles)
            td += time.time() - ts
            ts = time.time()
            if pending is not None:
                _drain(pending, writers, crop, overlap, pads, spatial)
            tw += time.time() - ts
            pending = (results, batch_origins[:real])
        ts = time.time()
        if pending is not None:
            _drain(pending, writers, crop, overlap, pads, spatial)
        tw += time.time() - ts
    total = time.time() - t0
    if times is not None:
        times.update({"tiles": len(origins), "total_s": round(total, 3),
                      "gather_s": round(tg, 3), "dispatch_s": round(td, 3),
                      "drain_s": round(tw, 3)})
    log.info("%s: %d tiles in %.2fs (gather %.2f, dispatch %.2f, drain %.2f)",
             desc, len(origins), total, tg, td, tw)


def _drain(pending, writers, crop, overlap, pads, spatial):
    results, batch_origins = pending
    for w, rn in zip(writers, _host_arrays(results)):
        w_arr, decode = w if isinstance(w, tuple) else (w, None)
        if decode is not None:
            rn = decode(rn)
        for i, o in enumerate(batch_origins):
            _write_interior(w_arr, rn[i], o, crop, overlap, pads, spatial)


def _write_interior(out_arr, tile, origin, crop, overlap, pads, spatial):
    src, dst = [], []
    for ax in range(3):
        lo = origin[ax] + overlap[ax] - pads[ax][0]  # dest, unpadded coords
        hi = origin[ax] + crop[ax] - overlap[ax] - pads[ax][0]
        s_lo, s_hi = overlap[ax], crop[ax] - overlap[ax]
        if lo < 0:
            s_lo -= lo
            lo = 0
        if hi > spatial[ax]:
            s_hi -= hi - spatial[ax]
            hi = spatial[ax]
        if hi <= lo:
            return
        dst.append(slice(lo, hi))
        src.append(slice(s_lo, s_hi))
    out_arr[tuple(dst)] = tile[tuple(src)]


def _probe_tiles(model, mean, std, volume, crop, ov, device, n_probe: int):
    """The model's output (an eval-mode model records no graph) on up to
    ``n_probe`` centre-most tiles of the host engine's grid over ``volume``
    ``[X, Y, Z, 1]``, one tile at a time."""
    spatial = volume.shape[:3]
    pads = [_pad_amounts(d, c, o) for d, c, o in zip(spatial, crop, ov)]
    padded_shape = tuple(d + p[0] + p[1] for d, p in zip(spatial, pads))
    center = [ps / 2 - c / 2 for ps, c in zip(padded_shape, crop)]
    origins = sorted(
        crop_origins(padded_shape, crop, ov),
        key=lambda o: sum((a - b) ** 2 for a, b in zip(o, center)),
    )[:n_probe]
    for o in origins:
        tile = torch.from_numpy(np.asarray(_read_tile(volume, o, crop, pads),
                                           np.float32)).to(device)
        yield model(((tile - mean) / std)[None])


def _probe_dilation(model, mean, std, prob_thr, volume, crop, ov, anisotropy,
                    device, n_probe: int = 4):
    """Minimum skeleton spacing over up to ``n_probe`` centre-most tiles of
    the host engine's grid, run with NO dilation; None when no probe shows
    two sizeable components (``engine.py:401-425``)."""
    gap = None
    for out in _probe_tiles(model, mean, std, volume, crop, ov, device, n_probe):
        _, skel, _ = tile_masks(out, prob_thr, prob_thr, 0, 0)
        g = estimate_skeleton_gap(skel[0].cpu().numpy(), anisotropy)
        if g is not None:
            gap = g if gap is None else min(gap, g)
    return gap


def _probe_probabilities(model, mean, std, volume, crop, ov, device,
                         n_probe: int = 4) -> np.ndarray:
    """The semantic probabilities of the probe tiles, f32, raveled and
    concatenated."""
    return np.concatenate([
        out[..., 4].float().cpu().numpy().ravel()
        for out in _probe_tiles(model, mean, std, volume, crop, ov, device,
                                n_probe)])


def _probe_semantic_threshold(model, mean, std, volume, crop, ov, device,
                              n_probe: int = 4) -> Optional[float]:
    """A sparse checkpoint's semantic threshold, calibrated on the volume
    itself (``engine.py:428-468``): the valley of the probability histogram
    of up to ``n_probe`` centre-most probe tiles. The threshold calibrated
    at training time measures the training distribution, which can sit on
    the wrong side of an inference volume's boundary ring. None when the
    probes show too little foreground to calibrate on."""
    return calibrate_semantic_threshold_from_histogram(_probe_probabilities(
        model, mean, std, volume, crop, ov, device, n_probe))


def _host_memory_report() -> tuple:
    """(current, peak) traced host bytes, or the process peak RSS twice when
    tracing is off."""
    if tracemalloc.is_tracing():
        return tracemalloc.get_traced_memory()
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return peak, peak


def _stream_stats(volume) -> Tuple[float, float]:
    """Mean and std of a (possibly memmapped) volume, 16 x-planes at a
    time."""
    n, tot, tot_sq = 0, 0.0, 0.0
    for i in range(0, volume.shape[0], 16):
        blk = np.asarray(volume[i:i + 16], np.float64)
        n += blk.size
        tot += float(blk.sum())
        tot_sq += float((blk * blk).sum())
    m = tot / n
    return m, max(tot_sq / n - m * m, 1e-8) ** 0.5


def _forward_tile_bytes(model, crops, prob_threshold, sem_thr, dilation_3d,
                        dilation_2d, device: torch.device) -> int:
    """Device memory that one forward tile needs: the segments the caching
    allocator reserves, from an emptied cache, to run a zero f32 tile of
    the largest of ``crops`` through the model and :func:`tile_masks` (its
    peak reserved memory, so the blocks a forward cannot reuse count too;
    this resets the allocator's peak statistics). 0 off a card, where the
    allocator keeps no statistics."""
    if device.type != "cuda":
        return 0
    crop = max(crops, key=lambda c: int(np.prod(c)))
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(device)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        out = model(torch.zeros((1, *crop, 1), device=device))[0]
        tile_masks(out, prob_threshold, sem_thr, dilation_3d, dilation_2d)
        del out
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_reserved(device) - base


def _forward_bytes_per_voxel(model, prob_threshold: float, device: torch.device) -> int:
    """The bytes a voxel of a sharded forward's slab needs on the card: the
    peak of the bytes one probe forward of :data:`FORWARD_PROBE` (with the
    sharded pipeline's fixed dilation stack) holds at once, which the
    allocator's statistics give whatever its cache holds, times
    :data:`RESERVED_PER_LIVE_BYTE`; 0 off a card."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        out = model(torch.zeros((1, *FORWARD_PROBE, 1), device=device))[0]
        tile_masks(out, prob_threshold, prob_threshold, 1, 2)
        del out
    torch.cuda.synchronize(device)
    live = torch.cuda.max_memory_allocated(device) - base
    return -(-RESERVED_PER_LIVE_BYTE * live // int(np.prod(FORWARD_PROBE)))


def choose_engine(volume_shape, itemsize: int, free_bytes: int,
                  tile_bytes: int) -> Tuple[str, dict]:
    """'auto''s engine for a volume over :data:`HOST_ENGINE_MAX_VOXELS` on a
    card with ``free_bytes`` free: the chunked pipeline ('device') when its
    estimate fits, else the thrifty one when that estimate fits, else the
    host engine; the host engine too past :data:`DEVICE_ENGINE_MAX_VOXELS`,
    where neither pipeline can run. Returns ``(engine, estimates)``, the
    estimates by engine (:func:`estimated_device_bytes` with one forward
    tile's ``tile_bytes``; ``itemsize`` is the volume's)."""
    est = {"device": estimated_device_bytes(volume_shape, tile_bytes=tile_bytes),
           "device-thrifty": estimated_device_bytes(
               volume_shape, thrifty=True, itemsize=itemsize, tile_bytes=tile_bytes)}
    if int(np.prod(volume_shape, dtype=np.int64)) > DEVICE_ENGINE_MAX_VOXELS:
        return "host", est
    for name in ("device", "device-thrifty"):
        if est[name] <= free_bytes:
            return name, est
    return "host", est


def _device_geometry(volume_shape, crop, crop_size, overlap, assign_crop_size):
    """The whole-volume pipeline's (tile, overlap, assign tile or None):
    explicit caller geometry wins; the reference defaults mean "unset" and
    get 256x256x96 tiles with no overlap, assigned on the same grid."""
    dev_crop = (256, 256, 96) if tuple(crop_size) == (300, 300, 20) else crop
    dev_ov = ((0, 0, 0) if tuple(overlap) == (50, 50, 5)
              else tuple(min(o, c // 4) for o, c in zip(overlap, dev_crop)))
    dev_assign = (None if tuple(assign_crop_size) == (500, 500, 50)
                  else tuple(min(a, d) for a, d in zip(assign_crop_size,
                                                       volume_shape)))
    return dev_crop, dev_ov, dev_assign


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (ValueError, OSError):
        return None


def _write_reports(stem: str, stats: dict, dt: float, owns_tracing: bool):
    with open(stem + "_skoots_phases.json", "w") as f:
        json.dump(stats, f, indent=1)
    cur, peak = _host_memory_report()
    if owns_tracing:
        tracemalloc.stop()
    with open(stem + "_skoots_benchmark.txt", "w") as f:
        f.write("SKOOTS Segmentation Benchmark:\n")
        f.write("------------------------------\n")
        f.write(f"Time: {dt} seconds\n")
        f.write(f"Memory (current/max): {(cur, peak)}\n\n")
    return peak


def _default_mask_path(image_path: str) -> str:
    """``<image>_instance_mask.tif``, or ``.npy`` for a ``.npy`` image (the
    JAX package writes a tif for every input)."""
    stem, ext = os.path.splitext(image_path)
    return stem + "_instance_mask" + (".npy" if ext.lower() == ".npy" else ".tif")


def run_inference(
    image_path: str,
    checkpoint_path: str,
    use_cached_data: bool = False,
    crop_size: Tuple[int, int, int] = (300, 300, 20),
    overlap: Tuple[int, int, int] = (50, 50, 5),
    assign_crop_size: Tuple[int, int, int] = (500, 500, 50),
    assign_overlap: Tuple[int, int, int] = (50, 50, 5),
    prob_threshold: float = 0.8,
    semantic_threshold: float | None = None,
    embed_iterations: int = 10,
    embed_decay: float = 1.0,
    embed_exit_fraction: float | None = None,
    embed_exit_cycle: bool = False,
    dilation_3d: int | None = None,
    dilation_2d: int | None = None,
    batch: int = 1,
    spatial_shards: int | None = 0,
    output_path: Optional[str] = None,
    out_of_core: Optional[bool] = None,
    semantic_gate: bool = True,
    label_crop_budget_bytes: Optional[int] = None,
    wire_mode: str = "auto",
    engine_impl: str = "auto",
    min_instance_size: int = -1,
    device=None,
) -> np.ndarray:
    """Segment a volume. Arguments are the JAX package's; ``device``
    defaults to the first CUDA card (``"cpu"`` runs every kernel's plain
    version on the CPU; asking for CUDA without one raises).

    ``engine_impl`` ('auto' | 'host' | 'device' | 'device-thrifty'; env
    ``SKOOTS_ENGINE``): 'auto' takes the host-streaming engine for volumes
    of 256^3 voxels or fewer, with a phase-1 cache in play, or with
    ``out_of_core=True``, and otherwise the whole-volume device pipeline
    when its estimated memory fits the card's free memory, or its
    device-thrifty form when only that one's estimate fits (each estimate
    is per-voxel buffers plus one forward tile's peak, which 'auto'
    measures with a zero tile; on the CPU no device limit exists, so 'auto'
    means host there), and the host engine again from 2^31 voxels, past
    the pipelines' int32 addresses (:func:`choose_engine`).
    ``out_of_core`` (default: over 256^3 voxels) keeps every full-volume
    host buffer in ``.npy`` memmaps beside the image. ``wire_mode`` ('auto' | 'store' | 'recompute'; env
    ``SKOOTS_WIRE_MODE``): 'store' keeps the f16 vector field for phase 3,
    'recompute' runs the forward again per assign tile; 'auto' recomputes
    out of core. Returns the instance mask ``[X, Y, Z]`` int32, labelled
    1..N (a memmap when out of core).

    ``spatial_shards`` (JAX's): ``None`` is auto — the sharded pipeline over
    every device of the call when there are several and the volume fits
    (``sharded.resolve_spatial_shards``), else 0; ``> 1`` shards X that many
    ways (raising when the call has fewer devices, or when even the ring
    estimate exceeds a card's free memory); 0 or 1 runs the engines above.
    The sharded pipeline writes ``<image>_skoots_benchmark.txt`` and the
    phases JSON, then drops specks, renumbers and writes the mask."""
    device, mesh_devices = resolve_devices(device)
    engine_impl = os.environ.get("SKOOTS_ENGINE", "") or engine_impl
    if engine_impl not in ("auto", "host", "device", "device-thrifty"):
        raise ValueError(
            f"engine_impl {engine_impl!r} not in auto/host/device/device-thrifty")

    notrace = os.environ.get("SKOOTS_NO_TRACEMALLOC", "") not in ("", "0")
    owns_tracing = (not notrace) and not tracemalloc.is_tracing()
    if owns_tracing:
        tracemalloc.start()
    t_start = time.time()
    stats: dict = {"tracemalloc": not notrace}
    global last_stats
    last_stats = stats
    try:
        stem = os.path.splitext(image_path)[0]
        ckpt = load_checkpoint(checkpoint_path)
        cfg = ckpt["cfg"]
        extra = ckpt.get("extra") or {}
        calibrated_thr = extra.get("calibrated_prob_threshold")
        sparse = (bool(cfg.get("EXPERIMENTAL", {}).get("IS_SPARSE"))
                  or calibrated_thr is not None)

        volume = imread(image_path)  # [X, Y, Z]
        x, y, z = volume.shape
        log.info("loaded %s: shape=%s dtype=%s", image_path, volume.shape,
                 volume.dtype)
        model = model_from_checkpoint(ckpt, device=device)
        if ckpt.get("dataset_mean") is not None:
            mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
        else:
            mean, std = _stream_stats(volume)
        vec_scale = tuple(cfg["SKOOTS"]["VECTOR_SCALING"])
        anisotropy = tuple(cfg["SKOOTS"]["ANISOTROPY"])

        fwd_bpv = functools.cache(
            lambda: _forward_bytes_per_voxel(model, prob_threshold, device))
        if spatial_shards is None:
            # auto (the CLI default): shard over every device when >1 is
            # present and the volume fits the sharded pipeline's per-device
            # ceiling; otherwise use the engines below
            limit = sharded.device_bytes_limit(mesh_devices[0])
            spatial_shards = sharded.resolve_spatial_shards(
                None, len(mesh_devices), (x, y, z), limit,
                fwd_bpv() if limit is not None and len(mesh_devices) > 1 else 0)
        if spatial_shards and spatial_shards > 1:
            return _run_sharded(
                model, volume, mean, std, mesh_devices, spatial_shards, stats,
                vec_scale, prob_threshold, embed_iterations,
                semantic_threshold if semantic_threshold is not None else
                (None if calibrated_thr is None else float(calibrated_thr)),
                fwd_bpv, stem, owns_tracing, min_instance_size,
                output_path or _default_mask_path(image_path))

        # canonical tile shapes: short axes round UP to the bucket ladder
        # (reflect-padded); the overlap keeps the stride >= crop / 2
        crop = bucketed_crop_size(
            tuple(max(4, c // 4 * 4) for c in crop_size), (x, y, z))
        ov = tuple(min(o, c // 4) for o, c in zip(overlap, crop))

        vec_path = stem + "_skoots_vectors.npy"
        skel_path = stem + "_skoots_skeleton.npy"
        sem_path = stem + "_skoots_semantic.npy"
        # the knobs baked into the cached buffers travel with them
        knobs_path = stem + "_skoots_phase1.json"

        requested_out_of_core = out_of_core
        if out_of_core is None:
            out_of_core = x * y * z > 256**3
        wire_mode = os.environ.get("SKOOTS_WIRE_MODE", "") or wire_mode
        if wire_mode == "auto":
            wire_mode = "recompute" if out_of_core else "store"
        if wire_mode not in ("store", "recompute"):
            raise ValueError(f"wire_mode {wire_mode!r} not in store/recompute/auto")
        stats["wire_mode"] = wire_mode

        # the masks alone make a usable cache; the vectors are absent when
        # the producing run recomputed them
        cache_hit = use_cached_data and all(
            os.path.exists(p) for p in (skel_path, sem_path))
        cache_has_vectors = cache_hit and os.path.exists(vec_path)

        if semantic_threshold is None:
            if sparse and not cache_hit:
                semantic_threshold = _probe_semantic_threshold(
                    model, mean, std, volume[..., None], crop, ov, device)
                if semantic_threshold is not None:
                    log.info("semantic gate: volume-calibrated threshold %.6f "
                             "(probability-histogram valley on probe tiles; "
                             "vector/skeleton masking stays at %.2f)",
                             semantic_threshold, prob_threshold)
            if semantic_threshold is None and calibrated_thr is not None:
                semantic_threshold = float(calibrated_thr)
                log.info("semantic gate: checkpoint-calibrated threshold %.6f",
                         semantic_threshold)
            if semantic_threshold is None:
                semantic_threshold = prob_threshold
                if sparse:
                    log.info("semantic gate: prob_threshold %.6f (no probe "
                             "or checkpoint calibration)", semantic_threshold)

        if dilation_3d is None or dilation_2d is None:
            if cache_hit:
                # the cached skeleton has its producing run's stack baked in
                rec = _read_json(knobs_path) or {}
                d3 = int(rec.get("dilation_3d", REFERENCE_STACK[0]))
                d2 = int(rec.get("dilation_2d", REFERENCE_STACK[1]))
            else:
                gap = _probe_dilation(model, mean, std, prob_threshold,
                                      volume[..., None], crop, ov, anisotropy,
                                      device)
                d3, d2 = derive_dilation(gap, anisotropy)
                log.info("auto dilation: measured skeleton spacing %s voxels "
                         "-> stack 3d=%d 2d=%d", "n/a" if gap is None else
                         f"{gap:.1f}", d3, d2)
            dilation_3d = d3 if dilation_3d is None else dilation_3d
            dilation_2d = d2 if dilation_2d is None else dilation_2d
        phase1_knobs = {"prob_threshold": prob_threshold,
                        "semantic_threshold": semantic_threshold,
                        "dilation_3d": dilation_3d, "dilation_2d": dilation_2d}

        use_device_engine = engine_impl in ("device", "device-thrifty")
        thrifty = engine_impl == "device-thrifty"
        # an explicit out_of_core=True pins the host-streaming engine
        if (engine_impl == "auto" and not cache_hit
                and requested_out_of_core is not True
                and x * y * z > HOST_ENGINE_MAX_VOXELS):
            limit = sharded.device_bytes_limit(device)
            if limit is not None:
                dev_crop, _, dev_assign = _device_geometry(
                    (x, y, z), crop, crop_size, overlap, assign_crop_size)
                tile_bytes = _forward_tile_bytes(
                    model, [dev_crop, dev_assign or dev_crop], prob_threshold,
                    semantic_threshold, dilation_3d, dilation_2d, device)
                choice, est = choose_engine((x, y, z), volume.dtype.itemsize,
                                            limit, tile_bytes)
                stats["auto"] = {"free_bytes": limit, "tile_bytes": tile_bytes,
                                 "estimated_bytes": est}
                use_device_engine = choice != "host"
                thrifty = choice == "device-thrifty"

        if use_device_engine:
            instance_mask = _run_device_engine(
                model, volume, mean, std, device, stats, crop, crop_size,
                overlap, assign_crop_size, vec_scale, prob_threshold,
                embed_iterations, embed_decay, embed_exit_fraction,
                embed_exit_cycle, dilation_3d, dilation_2d, semantic_threshold,
                semantic_gate, thrifty)
            dt = stats["e2e_s"]
            _write_reports(stem, stats, dt, owns_tracing)
            instance_mask, _ = drop_small_instances(instance_mask,
                                                    min_instance_size)
            instance_mask, _ = renumber(instance_mask)
            out_path = output_path or _default_mask_path(image_path)
            imsave(out_path, instance_mask)
            log.info("device-pipeline segmentation took %.2fs -> %s", dt, out_path)
            return instance_mask

        stats["engine"] = "host"
        stats["device"] = str(device)
        stats["out_of_core"] = bool(out_of_core)
        pin = device.type == "cuda"
        # ------------------------------------------------------------ phase 1
        if cache_hit:
            recorded = _read_json(knobs_path) if os.path.exists(knobs_path) else None
            if recorded is not None:
                recorded.setdefault("semantic_threshold",
                                    recorded.get("prob_threshold"))
                diffs = {k: f"cached={recorded.get(k)} requested={v}"
                         for k, v in phase1_knobs.items() if recorded.get(k) != v}
                if diffs:
                    log.warning("use_cached_data: cached phase-1 buffers were "
                                "produced with different knobs than requested; "
                                "the recorded values stay baked in: %s", diffs)
            elif (dilation_3d, dilation_2d) != (1, 2) or prob_threshold != 0.8:
                log.warning("use_cached_data: no phase-1 sidecar (%s): the "
                            "cached skeleton has its original run's threshold "
                            "and dilation baked in; --dilate-3d/--dilate-2d/"
                            "prob_threshold are ignored",
                            os.path.basename(knobs_path))
            vectors = np.load(vec_path, mmap_mode="r") if cache_has_vectors else None
            if vectors is None and wire_mode == "store":
                log.info("use_cached_data: no vector buffer in the cache "
                         "(produced under wire_mode='recompute'); phase 3 "
                         "recomputes the vectors on the device")
                wire_mode = "recompute"
            skeleton_u8 = np.load(skel_path, mmap_mode="r")
            semantic_u8 = np.load(sem_path, mmap_mode="r")
            bench_start = time.time()
        else:
            store_vectors = wire_mode == "store"
            vectors = None
            if out_of_core:
                if store_vectors:
                    vectors = open_outofcore(vec_path, (x, y, z, 3), "float16")
                skeleton_u8 = open_outofcore(skel_path, (x, y, z), "uint8")
                semantic_u8 = open_outofcore(sem_path, (x, y, z), "uint8")
            else:
                if store_vectors:
                    vectors = np.zeros((x, y, z, 3), np.float16)
                skeleton_u8 = np.zeros((x, y, z), np.uint8)
                semantic_u8 = np.zeros((x, y, z), np.uint8)
            pack_wire = crop[2] % 8 == 0
            tile_fn = _make_tile_fn(model, mean, std, prob_threshold,
                                    dilation_3d, dilation_2d,
                                    sem_thr=semantic_threshold,
                                    store_vectors=store_vectors,
                                    pack_wire=pack_wire, device=device)
            decode = _make_mask_decoder(crop[2]) if pack_wire else None
            writers = ([vectors] if store_vectors else []) + [
                (skeleton_u8, decode), (semantic_u8, decode)]
            bench_start = time.time()
            _sweep(volume[..., None], writers, tile_fn, crop, ov, batch,
                   "phase1-unet", times=stats.setdefault("phase1", {}), pin=pin)
            if out_of_core:
                for buf in ([vectors] if store_vectors else []) + [skeleton_u8,
                                                                   semantic_u8]:
                    buf.flush()
            else:
                if store_vectors:
                    np.save(vec_path, vectors)
                np.save(skel_path, skeleton_u8)
                np.save(sem_path, semantic_u8)
            if not store_vectors and os.path.exists(vec_path):
                os.remove(vec_path)  # a stale field would poison --use-cached
            phase1_knobs["vectors_stored"] = store_vectors
            with open(knobs_path, "w") as f:
                json.dump(phase1_knobs, f)

        # ------------------------------------------------------------ phase 2
        log.info("phase 2: flood fill")
        labels_out = (open_outofcore(stem + "_skoots_labels.npy", (x, y, z), "int32")
                      if out_of_core else None)
        # smaller CC tiles out of core bound host transients; short axes
        # round DOWN (the CC slices tiles directly)
        cc_crop = bucketed_crop_size_down(
            (256, 256, 64) if out_of_core else (512, 512, 128), (x, y, z))
        t2 = time.time()
        cc_info: dict = {}
        labeled = efficient_flood_fill(skeleton_u8, crop_size=cc_crop,
                                       out=labels_out, info=cc_info, device=device)
        stats["phase2"] = {"total_s": round(time.time() - t2, 3),
                           "cc_crop": list(cc_crop),
                           "max_label": cc_info.get("max_label"),
                           "cc_rounds": cc_info.get("rounds"),
                           "cc_converged": cc_info.get("converged"),
                           "cc_unconverged_tiles": cc_info.get("unconverged_tiles"),
                           "cc_tiles": cc_info.get("cc_tiles")}

        # ------------------------------------------------------------ phase 3
        log.info("phase 3: instance assignment")
        instance_mask = (open_outofcore(stem + "_skoots_instance.npy", (x, y, z),
                                        "int32")
                         if out_of_core else np.zeros((x, y, z), np.int32))
        _assign(volume, vectors, semantic_u8, labeled, instance_mask, model,
                mean, std, device, stats, wire_mode, assign_crop_size,
                assign_overlap, batch, vec_scale, prob_threshold,
                semantic_threshold, semantic_gate, embed_iterations, embed_decay,
                embed_exit_fraction, embed_exit_cycle, label_crop_budget_bytes,
                pin)

        dt = time.time() - bench_start
        stats["e2e_s"] = round(dt, 3)
        peak = _write_reports(stem, stats, dt, owns_tracing)
        log.info("segmentation took %.2fs (peak host mem %.1f MB)", dt, peak / 1e6)
        if out_of_core:
            drop_small_instances(instance_mask, min_instance_size)
            renumber_inplace(instance_mask)
            instance_mask.flush()
        else:
            instance_mask, _ = drop_small_instances(instance_mask,
                                                    min_instance_size)
            instance_mask, _ = renumber(instance_mask)
        out_path = output_path or _default_mask_path(image_path)
        imsave(out_path, instance_mask)
        log.info("wrote %s (total %.2fs)", out_path, time.time() - t_start)
        return instance_mask
    finally:
        if owns_tracing and tracemalloc.is_tracing():
            tracemalloc.stop()


def _run_sharded(model, volume, mean, std, mesh_devices, spatial_shards, stats,
                 vec_scale, prob_threshold, embed_iterations, semantic_threshold,
                 fwd_bpv, stem, owns_tracing, min_instance_size, out_path):
    """``run_inference``'s sharded branch (JAX's ``engine.py:639-713``)."""
    x, y, z = volume.shape
    n_dev = len(mesh_devices)
    if n_dev < spatial_shards:
        raise ValueError(
            f"--spatial-shards {spatial_shards} needs that many devices, "
            f"have {n_dev}"
        )
    limit = sharded.device_bytes_limit(mesh_devices[0])
    if limit is not None:
        # the pipeline auto-degrades its walk to ring gathers when the
        # replicated field doesn't fit, so the hard bar is the RING
        # estimate (everything O(vox/n)), with the forward's own need.
        # Fail with the remedy instead of running out of memory.
        need = sharded.estimated_bytes_per_device((x, y, z), spatial_shards, "ring",
                                                  fwd_bpv())
        if need > limit:
            raise ValueError(
                f"--spatial-shards {spatial_shards}: this volume needs "
                f"~{need / 1e9:.1f} GB/device even in the sharded "
                f"pipeline's ring-gathered mode but devices have "
                f"{limit / 1e9:.1f} GB. Use the host-streaming engine "
                "(--spatial-shards 0), whose phase 3 is O(tile), or "
                "more devices."
            )
    mesh = make_mesh(data=1, space=spatial_shards, devices=mesh_devices[:spatial_shards])
    if semantic_threshold is not None:
        log.info("semantic gate: threshold %.6f", semantic_threshold)
    run = sharded.make_sharded_pipeline(
        model, mesh, (x, y, z), vector_scale=vec_scale,
        prob_threshold=prob_threshold, embed_iterations=embed_iterations,
        semantic_threshold=semantic_threshold,
    )
    bench_start = time.time()
    instance_mask = run(volume, mean, std)
    dt = time.time() - bench_start
    stats.update(engine="sharded", spatial_shards=spatial_shards,
                 devices=[str(d) for d in mesh_devices[:spatial_shards]],
                 walk_gather=run.walk_gather, phases=run.last_phase_s,
                 cc_rounds=run.cc.last_rounds, cc_converged=run.cc.last_converged,
                 e2e_s=round(dt, 3))
    _write_reports(stem, stats, dt, owns_tracing)
    instance_mask, _ = drop_small_instances(np.asarray(instance_mask), min_instance_size)
    instance_mask, _ = renumber(instance_mask)
    imsave(out_path, instance_mask.astype(np.int32))
    log.info("sharded (%d-way) segmentation took %.2fs -> %s", spatial_shards, dt, out_path)
    return instance_mask


def _assign(volume, vectors, semantic_u8, labeled, instance_mask, model, mean,
            std, device, stats, wire_mode, assign_crop_size, assign_overlap,
            batch, vec_scale, prob_threshold, semantic_threshold, semantic_gate,
            embed_iterations, embed_decay, embed_exit_fraction, embed_exit_cycle,
            label_crop_budget_bytes, pin):
    """Phase 3 of the host engine, written into ``instance_mask``: per batch
    of assign tiles, the walk on the device (3a), then the ids gathered
    from the label crop its walks reach (3b), or from x-slabs of the labels
    when that crop exceeds ``label_crop_budget_bytes``."""
    x, y, z = instance_mask.shape
    a_crop = bucketed_crop_size(
        tuple(max(4, c // 4 * 4) for c in assign_crop_size), (x, y, z))
    a_ov = tuple(min(o, c // 4) for o, c in zip(assign_overlap, a_crop))
    if wire_mode == "recompute":
        embed_fn = _make_recompute_embed_fn(
            model, mean, std, prob_threshold,
            semantic_threshold if semantic_gate else None, vec_scale,
            (x, y, z), embed_iterations, embed_decay, embed_exit_fraction,
            embed_exit_cycle, device)
    else:
        embed_fn = _make_embed_fn(vec_scale, (x, y, z), embed_iterations,
                                  embed_decay, embed_exit_fraction,
                                  embed_exit_cycle, device)
    if label_crop_budget_bytes is None:
        label_crop_budget_bytes = int(
            os.environ.get("SKOOTS_LABEL_CROP_BYTES", 512 * 1024 * 1024))
    slab_depth = max(16, min(x, label_crop_budget_bytes // max(y * z * 4, 1))
                     // 16 * 16)
    streamed_batches = 0

    pads = [_pad_amounts(d, c, o) for d, c, o in zip((x, y, z), a_crop, a_ov)]
    padded_shape = tuple(d + p[0] + p[1] for d, p in zip((x, y, z), pads))
    origins = crop_origins(padded_shape, a_crop, a_ov)
    t3 = time.time()
    p3 = stats.setdefault("phase3", {
        "tiles": len(origins), "read_s": 0.0, "embed_s": 0.0,
        "labelcrop_s": 0.0, "gather_s": 0.0, "write_s": 0.0,
        "assign_crop": list(a_crop)})

    def host_tensor(a):
        t = torch.from_numpy(a)
        return t.pin_memory() if pin else t

    def read(batch_origins):
        """Host reads of one batch (on the read-ahead thread): raw image
        tiles (recompute), or f16 vectors and the semantic gate (store)."""
        if wire_mode == "recompute":
            return host_tensor(np.stack([_read_tile(volume[..., None], o, a_crop, pads)
                                         for o in batch_origins])), None
        t = np.stack([_read_tile(vectors, o, a_crop, pads) for o in batch_origins])
        if semantic_gate:
            f = np.stack([_read_tile(semantic_u8, o, a_crop, pads)
                          for o in batch_origins])
        else:
            f = np.ones((len(batch_origins), *a_crop), np.uint8)
        return host_tensor(t), host_tensor(f)

    def batch_at(bi):
        batch_origins = origins[bi:bi + batch]
        real = len(batch_origins)
        return batch_origins + [batch_origins[-1]] * (batch - real), real

    with ThreadPoolExecutor(1) as ex, torch.no_grad():
        fut = ex.submit(read, batch_at(0)[0]) if origins else None
        for bi in range(0, len(origins), batch):
            batch_origins, real = batch_at(bi)
            # offsets map padded-tile coordinates into the unpadded volume
            offs = np.asarray([[o[a] - pads[a][0] for a in range(3)]
                               for o in batch_origins], np.float32)
            ts = time.time()
            tiles, fg = fut.result()
            if bi + batch < len(origins):
                fut = ex.submit(read, batch_at(bi + batch)[0])
            p3["read_s"] += time.time() - ts
            ts = time.time()
            if wire_mode == "recompute":
                idx, fg_dev, mins, maxs = embed_fn(tiles, offs)
            else:
                idx, mins, maxs = embed_fn(tiles, offs)
                fg_dev = _upload(fg, device)
            lab_origin, lab_shape = _bucket_bbox(mins.cpu().numpy(),
                                                 maxs.cpu().numpy(), (x, y, z))
            p3["embed_s"] += time.time() - ts
            if lab_shape[0] * lab_shape[1] * lab_shape[2] * 4 <= label_crop_budget_bytes:
                ts = time.time()
                lab_sl = tuple(slice(o, o + s) for o, s in zip(lab_origin, lab_shape))
                labels_crop = np.ascontiguousarray(labeled[lab_sl])
                p3["labelcrop_s"] += time.time() - ts
                ts = time.time()
                ids = _gather_ids(_upload(labels_crop, device), idx, lab_origin,
                                  fg_dev).cpu().numpy()
                p3["gather_s"] += time.time() - ts
            else:
                if streamed_batches == 0:
                    log.warning(
                        "phase 3: walk bbox %s exceeds the label-crop budget "
                        "(%.0f MB, SKOOTS_LABEL_CROP_BYTES): streaming %d-deep "
                        "label slabs instead. This usually means the model's "
                        "embedding walks do not converge locally (untrained "
                        "weights or a wrong SKOOTS.VECTOR_SCALING).",
                        lab_shape, label_crop_budget_bytes / 1e6, slab_depth)
                streamed_batches += 1
                acc = torch.zeros(idx.shape[:-1], dtype=torch.int32, device=device)
                x_lo, x_hi = int(mins[0]), int(maxs[0]) + 1
                for xs in range((x_lo // slab_depth) * slab_depth, x_hi, slab_depth):
                    slab = np.ascontiguousarray(labeled[xs:xs + slab_depth])
                    acc = _gather_ids_slab(_upload(slab, device), idx, xs, fg_dev, acc)
                ids = acc.cpu().numpy()
            ts = time.time()
            for i, o in enumerate(batch_origins[:real]):
                _write_interior(instance_mask, ids[i], o, a_crop, a_ov, pads,
                                (x, y, z))
            p3["write_s"] += time.time() - ts
    p3["total_s"] = round(time.time() - t3, 3)
    p3["streamed_batches"] = streamed_batches
    for k in ("read_s", "embed_s", "labelcrop_s", "gather_s", "write_s"):
        p3[k] = round(p3[k], 3)
    log.info("phase 3: %d tiles in %.2fs (read %.2f, embed %.2f, labelcrop "
             "%.2f, gather %.2f, write %.2f)", p3["tiles"], p3["total_s"],
             p3["read_s"], p3["embed_s"], p3["labelcrop_s"], p3["gather_s"],
             p3["write_s"])


def _run_device_engine(model, volume, mean, std, device, stats, crop,
                       crop_size, overlap, assign_crop_size, vec_scale,
                       prob_threshold, embed_iterations, embed_decay,
                       embed_exit_fraction, embed_exit_cycle, dilation_3d,
                       dilation_2d, semantic_threshold, semantic_gate,
                       thrifty: bool):
    """The whole-volume device pipeline (its thrifty form with
    ``thrifty``) on the volume; fills ``stats`` and returns the int32
    instance mask before the finishers. On a card the pipeline hands the
    mask back in pinned host memory, complete, so nothing is copied here."""
    x, y, z = volume.shape
    dev_crop, dev_ov, dev_assign = _device_geometry(
        (x, y, z), crop, crop_size, overlap, assign_crop_size)
    log.info("engine: whole-volume device pipeline%s on %s (crop=%s overlap=%s)",
             " (thrifty)" if thrifty else "", device, dev_crop, dev_ov)
    make_pipeline = make_thrifty_pipeline if thrifty else make_chunked_pipeline
    run = make_pipeline(
        model, (x, y, z), crop=dev_crop, overlap=dev_ov, assign_crop=dev_assign,
        vector_scale=vec_scale, prob_threshold=prob_threshold,
        embed_iterations=embed_iterations, embed_decay=embed_decay,
        embed_exit_fraction=embed_exit_fraction,
        embed_exit_cycle=embed_exit_cycle,
        embed_compact_div=int(os.environ.get("SKOOTS_COMPACT_DIV", "16")) or None,
        dilation_3d=dilation_3d, dilation_2d=dilation_2d,
        semantic_threshold=semantic_threshold, semantic_gate=semantic_gate,
        device=device)
    bench_start = time.time()
    # widened on the host: a 16-bit mask crosses the wire as it is
    instance_mask = widen_u16(run(volume, mean, std)).numpy().astype(
        np.int32, copy=False)
    stats["engine"] = "device-thrifty" if thrifty else "device"
    stats["device"] = str(device)
    stats["out_of_core"] = False
    stats["phase_s"] = dict(run.last_phase_s)
    stats["tile_plan"] = dict(run.tile_plan)
    stats["cc_rounds"] = run.last_cc_rounds
    stats["cc_converged"] = run.last_cc_converged
    stats["e2e_s"] = round(time.time() - bench_start, 3)
    return instance_mask
