"""End-to-end SKOOTS inference: the ``skoots --image`` path on the device.

Port of the device branch of ``skoots_tpu/infer/engine.py::run_inference``
(:483-911): load the checkpoint and the volume, pick the semantic threshold
and (in auto mode) the dilation stack from probe tiles, run the whole-volume
pipeline (``infer/device_pipeline.py``), drop speck instances, renumber, and
write ``<image>_instance_mask.tif``, ``<image>_skoots_benchmark.txt`` and
``<image>_skoots_phases.json``.

The port runs the device engine at every volume size that fits the device.
Engines and options that are not ported yet -- the host-streaming engine,
the thrifty device pipeline, spatial sharding, ``--use-cached`` phase-1
buffers, out-of-core buffers, sparse-checkpoint threshold calibration --
raise ``NotImplementedError`` (see ROADMAP.md) instead of being ignored.
"""

from __future__ import annotations

import json
import logging
import os
import time
import tracemalloc
from typing import Optional, Tuple

import numpy as np
import torch

from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.infer.autoknobs import derive_dilation, estimate_skeleton_gap
from skoots_tpu_torch.infer.device_pipeline import (
    estimated_device_bytes,
    make_chunked_pipeline,
    tile_masks,
)
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.ops.cropper import bucketed_crop_size, crop_origins
from skoots_tpu_torch.ops.flood_fill import drop_small_instances, renumber
from skoots_tpu_torch.utils.io import imread, imsave

log = logging.getLogger(__name__)

_NOT_PORTED = "is not ported to skoots_tpu_torch yet (see ROADMAP.md)"


def _pad_amounts(dim: int, crop: int, ov: int) -> Tuple[int, int]:
    """Reflect-pad so tile interiors [ov, padded-ov) cover [0, dim)."""
    return ov, max(ov, crop - (dim + ov))


def _read_tile(volume: np.ndarray, origin, crop, pads) -> np.ndarray:
    """One padded-coordinate tile of the unpadded volume, reflect-padding
    only the tile edges."""
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


@torch.no_grad()
def _probe_dilation(model, mean, std, prob_thr, volume, crop, ov, anisotropy,
                    device, n_probe: int = 4):
    """Minimum skeleton spacing over up to ``n_probe`` centre-most tiles of
    the host engine's grid, run with NO dilation; None when no probe shows
    two sizeable components (``engine.py:401-425``)."""
    spatial = volume.shape[:3]
    pads = [_pad_amounts(d, c, o) for d, c, o in zip(spatial, crop, ov)]
    padded_shape = tuple(d + p[0] + p[1] for d, p in zip(spatial, pads))
    center = [ps / 2 - c / 2 for ps, c in zip(padded_shape, crop)]
    origins = sorted(
        crop_origins(padded_shape, crop, ov),
        key=lambda o: sum((a - b) ** 2 for a, b in zip(o, center)),
    )[:n_probe]
    gap = None
    for o in origins:
        tile = torch.from_numpy(np.asarray(_read_tile(volume, o, crop, pads),
                                           np.float32)).to(device)
        out = model(((tile - mean) / std)[None])
        _, skel, _ = tile_masks(out, prob_thr, prob_thr, 0, 0)
        g = estimate_skeleton_gap(skel[0].cpu().numpy(), anisotropy)
        if g is not None:
            gap = g if gap is None else min(gap, g)
    return gap


def _host_memory_report() -> tuple:
    """(current, peak) traced host bytes, or the process peak RSS twice when
    tracing is off."""
    if tracemalloc.is_tracing():
        return tracemalloc.get_traced_memory()
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return peak, peak


def _device_fits(device: torch.device, shape) -> bool:
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return estimated_device_bytes(shape) <= free


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
    """Segment a volume with the whole-volume device engine. Arguments are
    the JAX package's (``batch``, ``assign_overlap``, ``wire_mode`` and
    ``label_crop_budget_bytes`` steer only its host-streaming engine and are
    accepted here for signature parity). ``device`` defaults to the first
    CUDA device, else the CPU. Returns the instance mask ``[X, Y, Z]``
    int32, labelled 1..N."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    engine_impl = os.environ.get("SKOOTS_ENGINE", "") or engine_impl
    if engine_impl not in ("auto", "device"):
        raise NotImplementedError(f"engine {engine_impl!r} {_NOT_PORTED}")
    if use_cached_data:
        raise NotImplementedError(f"--use-cached {_NOT_PORTED}")
    if out_of_core:
        raise NotImplementedError(f"out-of-core buffers {_NOT_PORTED}")
    if spatial_shards is not None and spatial_shards > 1:
        raise NotImplementedError(f"--spatial-shards > 1 {_NOT_PORTED}")

    notrace = os.environ.get("SKOOTS_NO_TRACEMALLOC", "") not in ("", "0")
    owns_tracing = (not notrace) and not tracemalloc.is_tracing()
    if owns_tracing:
        tracemalloc.start()
    stats: dict = {"tracemalloc": not notrace}
    try:
        stem = os.path.splitext(image_path)[0]
        ckpt = load_checkpoint(checkpoint_path)
        cfg = ckpt["cfg"]
        extra = ckpt.get("extra") or {}
        sparse = (cfg.get("EXPERIMENTAL", {}).get("IS_SPARSE")
                  or extra.get("calibrated_prob_threshold") is not None)
        if sparse and semantic_threshold is None:
            raise NotImplementedError(
                f"sparse-checkpoint threshold calibration {_NOT_PORTED}")

        volume = imread(image_path)  # [X, Y, Z]
        x, y, z = volume.shape
        log.info("loaded %s: shape=%s dtype=%s", image_path, volume.shape,
                 volume.dtype)
        if not _device_fits(device, (x, y, z)):
            raise NotImplementedError(
                f"volume {volume.shape} exceeds {device} memory; the "
                f"host-streaming engine {_NOT_PORTED}")

        model = model_from_checkpoint(ckpt, device=device)
        if ckpt.get("dataset_mean") is not None:
            mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
        else:
            v = np.asarray(volume, np.float64)
            mean = float(v.mean())
            std = max(float((v * v).mean()) - mean * mean, 1e-8) ** 0.5
        vec_scale = tuple(cfg["SKOOTS"]["VECTOR_SCALING"])
        if semantic_threshold is None:
            semantic_threshold = prob_threshold

        wire_mode = os.environ.get("SKOOTS_WIRE_MODE", "") or wire_mode
        if wire_mode == "auto":
            wire_mode = "store"
        if wire_mode not in ("store", "recompute"):
            raise ValueError(f"wire_mode {wire_mode!r} not in store/recompute/auto")
        stats["wire_mode"] = wire_mode

        # the host engine's tile grid: the dilation probe runs on it
        crop = bucketed_crop_size(
            tuple(max(4, c // 4 * 4) for c in crop_size), (x, y, z))
        ov = tuple(min(o, c // 4) for o, c in zip(overlap, crop))
        if dilation_3d is None or dilation_2d is None:
            anisotropy = tuple(cfg["SKOOTS"]["ANISOTROPY"])
            gap = _probe_dilation(model, mean, std, prob_threshold,
                                  volume[..., None], crop, ov, anisotropy,
                                  device)
            d3, d2 = derive_dilation(gap, anisotropy)
            log.info("auto dilation: measured skeleton spacing %s voxels -> "
                     "stack 3d=%d 2d=%d", "n/a" if gap is None else
                     f"{gap:.1f}", d3, d2)
            dilation_3d = d3 if dilation_3d is None else dilation_3d
            dilation_2d = d2 if dilation_2d is None else dilation_2d

        # explicit caller geometry wins; the reference defaults mean "unset"
        # and get the zero-overlap device grid
        dev_crop = (256, 256, 96) if tuple(crop_size) == (300, 300, 20) else crop
        dev_ov = ((0, 0, 0) if tuple(overlap) == (50, 50, 5)
                  else tuple(min(o, c // 4) for o, c in zip(overlap, dev_crop)))
        dev_assign = (None if tuple(assign_crop_size) == (500, 500, 50)
                      else tuple(min(a, d) for a, d in
                                 zip(assign_crop_size, (x, y, z))))
        log.info("engine: whole-volume device pipeline on %s (crop=%s "
                 "overlap=%s)", device, dev_crop, dev_ov)
        run = make_chunked_pipeline(
            model, (x, y, z), crop=dev_crop, overlap=dev_ov,
            assign_crop=dev_assign, vector_scale=vec_scale,
            prob_threshold=prob_threshold,
            embed_iterations=embed_iterations, embed_decay=embed_decay,
            embed_exit_fraction=embed_exit_fraction,
            embed_exit_cycle=embed_exit_cycle,
            embed_compact_div=(
                int(os.environ.get("SKOOTS_COMPACT_DIV", "16")) or None),
            dilation_3d=dilation_3d, dilation_2d=dilation_2d,
            semantic_threshold=semantic_threshold,
            semantic_gate=semantic_gate, device=device,
        )
        bench_start = time.time()
        instance_mask = run(volume, mean, std).cpu().numpy().astype(np.int32)
        dt = time.time() - bench_start
        stats["engine"] = "device"
        stats["device"] = str(device)
        stats["phase_s"] = dict(run.last_phase_s)
        stats["e2e_s"] = round(dt, 3)
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
        instance_mask, _ = drop_small_instances(instance_mask, min_instance_size)
        instance_mask, _ = renumber(instance_mask)
        out_path = output_path or (stem + "_instance_mask.tif")
        imsave(out_path, instance_mask)
        log.info("device-pipeline segmentation took %.2fs -> %s", dt, out_path)
        return instance_mask
    finally:
        if owns_tracing and tracemalloc.is_tracing():
            tracemalloc.stop()
