"""Datasets and host batch assembly for training (port of
``skoots_tpu/train/data.py``).

The host side is numpy, copied from the JAX package, so the same dataset
and seed give the same host batches: the skeleton-centred pre-crop and the
packed skeleton points, stacked per batch. All augmentation runs on the
device (``train/transforms.py``).

File contract per volume (reference dataloader.py:96-114):
    <name>.tif              image
    <name>.labels.tif       instance masks
    <name>.skeletons.npz    ground-truth skeletons ({id: [M, 3]}; .trch too;
                            made by Lee thinning and written when absent)
"""

from __future__ import annotations

import glob
import logging
import os
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from skoots_tpu_torch.train.generate_skeletons import (
    calculate_skeletons,
    load_skeletons,
    save_skeletons,
)
from skoots_tpu_torch.utils.io import imread

log = logging.getLogger(__name__)


class VolumeRecord:
    def __init__(self, image: np.ndarray, masks: Optional[np.ndarray],
                 skeletons: Dict[int, np.ndarray], name: str = ""):
        self.image = image
        self.masks = masks
        self.skeletons = {k: v for k, v in skeletons.items() if k != -1}
        self.name = name


def _find_skeletons(base: str) -> Optional[str]:
    for ext in (".skeletons.npz", ".skeletons.trch"):
        if os.path.exists(base + ext):
            return base + ext
    return None


def _load_dir(p: str, background: bool) -> List[VolumeRecord]:
    if background:
        # background dirs hold plain images with no instances
        files = [f for f in sorted(glob.glob(os.path.join(p, "*.tif")))
                 if ".labels." not in f]
        return [VolumeRecord(imread(f).astype(np.float32), None, {}, f) for f in files]
    records = []
    for f in sorted(glob.glob(os.path.join(p, "*.labels.tif"))):
        base = f[: -len(".labels.tif")]
        img_path = base + ".tif"
        if not os.path.exists(img_path):
            raise FileNotFoundError(f"no image for {f}: expected {img_path}")
        masks = imread(f).astype(np.int32)
        skel_path = _find_skeletons(base)
        if skel_path:
            skeletons = load_skeletons(skel_path)
        else:
            log.warning("no skeleton file for %s; computing lee skeletons", base)
            skeletons = calculate_skeletons(masks, method="lee")
            save_skeletons(base + ".skeletons.npz", skeletons)
        records.append(VolumeRecord(imread(img_path).astype(np.float32), masks,
                                    skeletons, base))
    return records


class SkootsDataset:
    """Instance-labelled training volumes with a sampling multiplicity per
    image. ``paths`` is a directory (or several) in the file contract above,
    or a list of in-memory :class:`VolumeRecord`\\ s."""

    def __init__(
        self,
        paths: Sequence[str] | str | Sequence[VolumeRecord],
        cfg: dict,
        sample_per_image: int = 1,
        background: bool = False,
    ):
        paths = [paths] if isinstance(paths, str) else list(paths)
        A = cfg["AUGMENTATION"]
        self.crop = (A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"])
        # pre-crop = crop + the reference's 300-voxel margin in XY
        self.pre = (self.crop[0] + 300, self.crop[1] + 300, self.crop[2])
        self.max_points = cfg["TRAIN"]["MAX_SKELETON_POINTS"]
        self.sample_per_image = sample_per_image
        self.background = background
        self.background_mask_mode = cfg["TRAIN"].get("BACKGROUND_MASK_MODE", "zeros")
        self.records: List[VolumeRecord] = []
        for p in paths:
            if isinstance(p, VolumeRecord):
                self.records.append(p)
            else:
                self.records.extend(_load_dir(p, background))
        if not self.records:
            raise FileNotFoundError(f"no training volumes found under {paths}")

        # shrink the static pre-crop to the smallest member volume (never
        # below the crop), so a small volume is not padded into a corner
        vol_min = np.min([r.image.shape for r in self.records], axis=0)
        self.pre = tuple(max(c, min(p, int(v)))
                         for p, c, v in zip(self.pre, self.crop, vol_min))

    def __len__(self) -> int:
        return len(self.records) * self.sample_per_image

    def moments(self) -> Tuple[int, float, float, float]:
        """Raw moments ``(n, sum, sum_sq, max)`` over all volumes."""
        total, total_sq, n, mx = 0.0, 0.0, 0, 0.0
        for r in self.records:
            total += float(r.image.sum())
            total_sq += float((r.image.astype(np.float64) ** 2).sum())
            n += r.image.size
            mx = max(mx, float(r.image.max()))
        return n, total, total_sq, mx

    def intensity_ceiling(self) -> float:
        """255 for 8-bit-range data, 65535 for 16-bit."""
        return 255.0 if self.moments()[3] <= 255.0 else 65535.0

    def object_radius(self) -> Optional[float]:
        """Median EDT at the skeleton points over the dataset (None for
        background-only data), stored in the checkpoint."""
        if self.background:
            return None
        from skoots_tpu_torch.infer.autoknobs import estimate_object_radius

        vals = [r for rec in self.records if rec.skeletons
                for r in [estimate_object_radius(rec.masks, rec.skeletons)]
                if r is not None]
        return float(np.median(vals)) if vals else None

    def mean_std(self, with_invert: bool = False) -> Tuple[float, float]:
        """Dataset intensity statistics; ``with_invert`` folds in the
        inverted copy of every image, exactly, from the raw moments."""
        return _mean_std(*self.moments(), with_invert)

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Draw one fixed-shape host sample (``train/transforms.py``'s
        contract)."""
        rec = self.records[rng.integers(len(self.records))]
        vol_shape = rec.image.shape
        pre = tuple(min(p, s) for p, s in zip(self.pre, vol_shape))

        if self.background or not rec.skeletons:
            center_abs = np.array(
                [rng.integers(0, max(s - 1, 1)) for s in vol_shape], np.float64)
        else:
            key = list(rec.skeletons.keys())[rng.integers(len(rec.skeletons))]
            center_abs = rec.skeletons[key].mean(axis=0)

        origin = np.clip(np.round(center_abs - np.asarray(pre) / 2).astype(np.int64),
                         0, np.asarray(vol_shape) - np.asarray(pre))
        sl = tuple(slice(o, o + p) for o, p in zip(origin, pre))
        image = rec.image[sl]
        bg_fill = int(self.background and self.background_mask_mode == "ones"
                      and rec.masks is None)
        masks = rec.masks[sl] if rec.masks is not None else np.full(pre, bg_fill, np.int32)

        pad = [(0, p - s) for p, s in zip(self.pre, image.shape)]
        if any(p[1] for p in pad):
            image = np.pad(image, pad, mode="reflect")
            masks = np.pad(masks, pad, mode="constant", constant_values=bg_fill)

        pts = np.zeros((self.max_points, 3), np.float32)
        ids = np.zeros((self.max_points,), np.int32)
        if rec.skeletons:
            all_pts, all_ids = [], []
            for k, v in rec.skeletons.items():
                all_pts.append(v - origin[None, :])
                all_ids.append(np.full(len(v), k, np.int32))
            all_pts = np.concatenate(all_pts)
            all_ids = np.concatenate(all_ids)
            # keep points near the pre-crop (their instances may extend out)
            inside = np.all((all_pts > -50) & (all_pts < np.asarray(self.pre) + 50), axis=1)
            all_pts, all_ids = all_pts[inside], all_ids[inside]
            if len(all_pts) > self.max_points:
                sel = rng.choice(len(all_pts), self.max_points, replace=False)
                all_pts, all_ids = all_pts[sel], all_ids[sel]
            pts[: len(all_pts)] = all_pts
            ids[: len(all_ids)] = all_ids

        return {
            "image": image.astype(np.float32),
            "masks": masks.astype(np.int32),
            "points": pts,
            "ids": ids,
            "center": (center_abs - origin).astype(np.float32),
        }


def _mean_std(n, total, total_sq, mx, with_invert: bool) -> Tuple[float, float]:
    if with_invert:
        ceil = 255.0 if mx <= 255.0 else 65535.0
        total_sq = 2 * total_sq + n * ceil**2 - 2 * ceil * total
        total = n * ceil  # sum x + sum (L - x)
        n *= 2
    mean = total / n
    std = max((total_sq / n - mean**2), 1e-8) ** 0.5
    return mean, std


class MultiDataset:
    """Concatenation with per-source sampling weights."""

    def __init__(self, datasets: Sequence[SkootsDataset]):
        self.datasets = [d for d in datasets if d is not None and len(d)]
        if not self.datasets:
            raise ValueError("MultiDataset needs at least one non-empty dataset")
        self.weights = np.asarray([len(d) for d in self.datasets], np.float64)
        self.weights /= self.weights.sum()

    def __len__(self) -> int:
        return int(sum(len(d) for d in self.datasets))

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        i = rng.choice(len(self.datasets), p=self.weights)
        return self.datasets[i].sample(rng)

    def intensity_ceiling(self) -> float:
        return max(d.intensity_ceiling() for d in self.datasets)

    def object_radius(self) -> Optional[float]:
        vals = [r for d in self.datasets for r in [d.object_radius()] if r is not None]
        return float(np.median(vals)) if vals else None

    def mean_std(self, with_invert: bool = False) -> Tuple[float, float]:
        n, total, total_sq, mx = 0, 0.0, 0.0, 0.0
        for d in self.datasets:
            dn, dt, dsq, dmx = d.moments()
            n, total, total_sq, mx = n + dn, total + dt, total_sq + dsq, max(mx, dmx)
        return _mean_std(n, total, total_sq, mx, with_invert)


def batch_iterator(dataset, batch_size: int, steps_per_epoch: int, seed: int):
    """``epoch_iter(epoch)`` yielding stacked host batches; epoch ``e``
    draws from ``np.random.default_rng(seed + e * 7919)``."""

    def epoch_iter(epoch: int):
        rng = np.random.default_rng(seed + epoch * 7919)
        for _ in range(steps_per_epoch):
            samples = [dataset.sample(rng) for _ in range(batch_size)]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    return epoch_iter


def prefetch_iterator(epoch_iter, depth: int = 2):
    """Wrap ``epoch_iter(epoch)`` so host batches are made on a background
    thread up to ``depth`` ahead of the consumer; an error in the producer
    is raised on the consumer's side."""

    def wrapped(epoch: int):
        q: queue.Queue = queue.Queue(maxsize=depth)
        end = object()

        def produce():
            try:
                for item in epoch_iter(epoch):
                    q.put(item)
                q.put(end)
            except BaseException as e:  # handed to the consumer, who raises it
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join(timeout=5)

    return wrapped
