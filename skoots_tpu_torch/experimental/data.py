"""Sparse-annotation volumes for weakly supervised training (port of
``skoots_tpu/experimental/data.py``).

File contract per volume (a directory holds any number):
    <name>.tif                image
    <name>.background.tif     certain-background mask (nonzero = background)
    <name>.skeleton_mask.tif  skeleton stamp (optional; painted from the
                              points when absent)
    <name>.skeletons.npz      skeleton point annotations ({id: [M, 3]};
                              .skeletons.trch too)

The dataset also takes in-memory :class:`SparseRecord`\\ s, so a caller
without files can train. The host sampling is numpy,
copied from the JAX package: the same records, cfg and ``Generator`` give
the same arrays.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from skoots_tpu_torch.experimental.modifiers import ablate_bg_masks, erode_bg_masks
from skoots_tpu_torch.ops.skeleton import pack_skeletons, skeleton_to_mask
from skoots_tpu_torch.train.generate_skeletons import load_skeletons
from skoots_tpu_torch.utils.io import imread


class SparseRecord:
    """One sparse volume: ``image`` ``[X, Y, Z]``, ``background`` (1 =
    certain background), ``skel_mask`` (the skeleton stamp, or None to
    paint it from ``skeletons``) and ``skeletons`` ``{id: [M, 3]}``."""

    def __init__(self, image: np.ndarray, background: np.ndarray,
                 skel_mask: Optional[np.ndarray], skeletons: Dict[int, np.ndarray],
                 name: str = ""):
        self.image = image
        self.background = background
        self.skel_mask = skel_mask
        self.skeletons = skeletons
        self.name = name


def _load_dir(p: str) -> List[SparseRecord]:
    records = []
    for f in sorted(glob.glob(os.path.join(p, "*.background.tif"))):
        base = f[: -len(".background.tif")]
        sk_path = base + ".skeleton_mask.tif"
        skel_mask = (imread(sk_path) > 0).astype(np.float32) if os.path.exists(sk_path) \
            else None
        skel_file = next((base + ext for ext in (".skeletons.npz", ".skeletons.trch")
                          if os.path.exists(base + ext)), None)
        records.append(SparseRecord(
            imread(base + ".tif").astype(np.float32), (imread(f) > 0).astype(np.float32),
            skel_mask, load_skeletons(skel_file) if skel_file else {}, base))
    return records


class SparseDataset:
    """Sparse volumes from directories in the file contract above, or a
    list of :class:`SparseRecord`\\ s. The cfg's background ablations
    (``EXPERIMENTAL.BACKGROUND_N_ERODE``, ``BACKGROUND_SLICE_PERCENTAGE``)
    apply to every record's background; a missing skeleton stamp is painted
    from the points (``TRAIN.SKELETON_MASK_RADIUS`` / ``_FLANK_RADIUS``)."""

    def __init__(self, paths: Sequence[str] | str | Sequence[SparseRecord], cfg: dict,
                 sample_per_image: int = 1):
        paths = [paths] if isinstance(paths, str) else list(paths)
        A, X, T = cfg["AUGMENTATION"], cfg["EXPERIMENTAL"], cfg["TRAIN"]
        self.crop = (A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"])
        self.pre = (self.crop[0] + 300, self.crop[1] + 300, self.crop[2])
        self.max_points = T["MAX_SKELETON_POINTS"]
        self.sample_per_image = sample_per_image
        self.records: List[SparseRecord] = []
        for p in paths:
            for rec in [p] if isinstance(p, SparseRecord) else _load_dir(p):
                background = rec.background
                if X["BACKGROUND_N_ERODE"]:
                    background = erode_bg_masks(background, X["BACKGROUND_N_ERODE"])
                if X["BACKGROUND_SLICE_PERCENTAGE"] < 1.0:
                    background = ablate_bg_masks(background, X["BACKGROUND_SLICE_PERCENTAGE"])
                skel_mask = rec.skel_mask
                if skel_mask is None:
                    skel_mask = skeleton_to_mask(
                        pack_skeletons(rec.skeletons), rec.image.shape,
                        radius=T["SKELETON_MASK_RADIUS"],
                        flank_radius=T["SKELETON_MASK_FLANK_RADIUS"]).numpy()
                self.records.append(SparseRecord(rec.image, background, skel_mask,
                                                 rec.skeletons, rec.name))
        if not self.records:
            raise FileNotFoundError(f"no *.background.tif sparse volumes under {paths}")

    def __len__(self) -> int:
        return len(self.records) * self.sample_per_image

    def sample(self, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """One fixed-shape host sample: the pre-crop around a random
        instance's skeleton centre, its background in the ``masks`` slot of
        the shared augmentation and its skeleton stamp under ``aux``."""
        rec = self.records[rng.integers(len(self.records))]
        vol_shape = rec.image.shape
        pre = tuple(min(p, s) for p, s in zip(self.pre, vol_shape))

        if rec.skeletons:
            key = list(rec.skeletons.keys())[rng.integers(len(rec.skeletons))]
            center_abs = rec.skeletons[key].mean(axis=0)
        else:
            center_abs = np.asarray([rng.integers(0, max(s - 1, 1)) for s in vol_shape],
                                    np.float64)

        origin = np.clip(np.round(center_abs - np.asarray(pre) / 2).astype(np.int64),
                         0, np.asarray(vol_shape) - np.asarray(pre))
        sl = tuple(slice(o, o + p) for o, p in zip(origin, pre))
        image = rec.image[sl]
        background = rec.background[sl]
        skel_mask = rec.skel_mask[sl]
        pad = [(0, p - s) for p, s in zip(self.pre, image.shape)]
        if any(p[1] for p in pad):
            image = np.pad(image, pad, mode="reflect")
            background = np.pad(background, pad, mode="constant", constant_values=1.0)
            skel_mask = np.pad(skel_mask, pad, mode="constant")

        pts = np.zeros((self.max_points, 3), np.float32)
        ids = np.zeros((self.max_points,), np.int32)
        if rec.skeletons:
            all_pts = np.concatenate([v - origin[None, :] for v in rec.skeletons.values()])
            all_ids = np.concatenate([np.full(len(v), k, np.int32)
                                      for k, v in rec.skeletons.items()])
            inside = np.all((all_pts > -50) & (all_pts < np.asarray(self.pre) + 50), axis=1)
            all_pts, all_ids = all_pts[inside], all_ids[inside]
            if len(all_pts) > self.max_points:
                sel = rng.choice(len(all_pts), self.max_points, replace=False)
                all_pts, all_ids = all_pts[sel], all_ids[sel]
            pts[: len(all_pts)] = all_pts
            ids[: len(all_ids)] = all_ids

        return {
            "image": image.astype(np.float32),
            "masks": background.astype(np.int32),
            "aux": skel_mask.astype(np.float32),
            "points": pts,
            "ids": ids,
            "center": (center_abs - origin).astype(np.float32),
        }
