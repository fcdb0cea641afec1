"""Sparse (weakly supervised) training (port of
``skoots_tpu/experimental/sparse_engine.py``).

The dense engine's skeleton with three differences: the loss bakes the
merged skeleton points on the fly (``sparse_loss.py``), the semantic head
is supervised by the thresholded embedding probability, and SWA averages
the parameters from ``int(0.75 * NUM_EPOCHS)`` on. A sparse checkpoint
also records the semantic threshold that :func:`make_threshold_calibrator`
measures on training crops, which inference then adopts.

A non-finite loss skips the whole update -- parameters, optimizer state
and the optimizer's step count -- as the original SKOOTS does. (The JAX
package keeps the parameters but takes the optimizer state of the
poisoned update, so its next update writes NaN.) The check reads the loss
on the host, one synchronisation a step.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from skoots_tpu_torch.checkpoint import save_checkpoint
from skoots_tpu_torch.experimental.data import SparseDataset, SparseRecord
from skoots_tpu_torch.experimental.sparse_loss import sparse_loss
from skoots_tpu_torch.infer.autoknobs import (
    calibrate_semantic_threshold,
    sparse_target_fg_fraction,
    suggest_dist_thr_from_points,
)
from skoots_tpu_torch.models import cfg_to_model, init_model
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.train.data import batch_iterator, prefetch_iterator
from skoots_tpu_torch.train.engine import TrainState, cfg_optimizer, flax_opt_state
from skoots_tpu_torch.train.losses import cfg_loss
from skoots_tpu_torch.train.sigma import Sigma, init_sigma
from skoots_tpu_torch.train.transforms import make_augment

log = logging.getLogger(__name__)


def make_sparse_augment(cfg: dict, dataset_mean: float = 0.0, dataset_std: float = 1.0,
                        device=None) -> Callable:
    """``fn(host_batch, gen) -> batch``: moves a stacked host batch of
    :meth:`SparseDataset.sample`\\ s to ``device`` and runs the dense
    augmentation's spatial and intensity core on each sample (background in
    the masks slot, the skeleton stamp as its aux volume). Batch,
    channels-last: image ``[B, W, H, D, 1]`` normalised, background and
    skele_masks ``[B, W, H, D, 1]`` f32 binary, points ``[B, P, 3]``,
    valid ``[B, P]`` bool."""
    core = make_augment(cfg, dataset_mean, dataset_std).geometric_core

    def batch_aug(host_batch: Dict[str, np.ndarray], gen: torch.Generator):
        outs = []
        for i in range(host_batch["image"].shape[0]):
            sample = {k: torch.from_numpy(np.ascontiguousarray(v[i]))
                      for k, v in host_batch.items()}
            sample = {k: v if k == "center" else v.to(device) for k, v in sample.items()}
            image, background, skel_mask, pts, ids = core(sample, gen)
            outs.append({"image": image[..., None],
                         "background": (background > 0).float()[..., None],
                         "skele_masks": (skel_mask > 0).float()[..., None],
                         "points": pts, "valid": ids != 0})
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return batch_aug


def make_sparse_train_step(model, optimizer: torch.optim.Optimizer,
                           schedule: Callable[[int], float], sigma: Sigma, cfg: dict):
    """``step(batch, epoch) -> metrics`` (loss, embed, prob, skele, lr and
    ``skipped``, True where a non-finite loss skipped the update), with
    ``step.loss_fn(batch, epoch) -> (total, metrics)`` and
    ``step.apply_update(epoch) -> lr`` public so a caller can time them
    apart. Sigma and lr are the epoch's, computed on the host."""
    t, x = cfg["TRAIN"], cfg["EXPERIMENTAL"]
    loss_skele = cfg_loss(t["LOSS_SKELETON"], t["LOSS_SKELETON_KEYWORDS"],
                          t["LOSS_SKELETON_VALUES"])
    anisotropy = tuple(float(a) for a in cfg["AUGMENTATION"]["BAKE_SKELETON_ANISOTROPY"])
    scale = tuple(float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"])
    weights = (t["LOSS_EMBED_RELATIVE_WEIGHT"], t["LOSS_PROBABILITY_RELATIVE_WEIGHT"],
               t["LOSS_SKELETON_RELATIVE_WEIGHT"])
    starts = (t["LOSS_EMBED_START_EPOCH"], t["LOSS_PROBABILITY_START_EPOCH"],
              t["LOSS_SKELETON_START_EPOCH"])

    def loss_fn(batch, epoch: int):
        out = model(batch["image"])
        vec, skel, prob = out[..., 0:3], out[..., 3:4], out[..., 4:5]
        embedding = vector_to_embedding(scale, vec)
        l_bg, l_embed, _ = sparse_loss(
            embed=embedding,
            vectors=vec * torch.tensor(scale, device=vec.device),
            points=batch["points"], valid=batch["valid"], background=batch["background"],
            semantic=prob, sigma=sigma(epoch), anisotropy=anisotropy,
            distance_thr=float(x["DIST_THR"]),
            bg_multiplier=float(x["SPARSE_BACKGROUND_PENALTY_MULTIPLIER"]))
        l_skel = loss_skele(skel, (batch["skele_masks"] > 0).float())
        terms = (l_embed, l_bg, l_skel)
        # epoch gating, strict >: a gated-off term still enters times 0
        total = sum(w * float(epoch > e0) * term
                    for w, e0, term in zip(weights, starts, terms))
        return total, {"loss": total.detach(), "embed": l_embed.detach(),
                       "prob": l_bg.detach(), "skele": l_skel.detach()}

    def apply_update(epoch: int) -> float:
        lr = schedule(epoch)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return lr

    def step(batch, epoch: int) -> Dict[str, Any]:
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, epoch)
        metrics["skipped"] = not bool(torch.isfinite(total))
        if metrics["skipped"]:
            log.warning("non-finite loss at epoch %d: the update is skipped", epoch)
            metrics["lr"] = schedule(epoch)
            return metrics
        total.backward()
        metrics["lr"] = apply_update(epoch)
        return metrics

    step.loss_fn = loss_fn
    step.apply_update = apply_update
    return step


def make_threshold_calibrator(cfg: dict, dataset, mean: float, std: float,
                              n_crops: int = 8) -> Callable:
    """``calibrate(model) -> threshold or None``: the semantic threshold
    whose predicted foreground volume matches the supervised geometry (the
    ``DIST_THR`` ball around the annotated points), measured on ``n_crops``
    crop-sized windows centred on the sampled skeletons of
    ``dataset.sample`` with ``np.random.default_rng(TRAIN.SEED + 7)``.
    Windows without points are skipped; none left gives None.
    ``calibrate.forwards`` counts the model forwards run so far."""
    A = cfg["AUGMENTATION"]
    crop = (A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"])
    aniso = tuple(A["BAKE_SKELETON_ANISOTROPY"])
    dist_thr = float(cfg["EXPERIMENTAL"]["DIST_THR"])

    @torch.no_grad()
    def calibrate(model) -> Optional[float]:
        dev = next(model.parameters()).device
        rng = np.random.default_rng(cfg["TRAIN"]["SEED"] + 7)
        probs, fracs = [], []
        for _ in range(n_crops):
            s = dataset.sample(rng)
            img = s["image"]
            # the sample pads at its END, so the data and the annotated
            # object sit toward the low corner: centre the window on the
            # sampled skeleton, clipped in bounds
            off = np.clip(np.round(s["center"] - np.asarray(crop, np.float32) / 2), 0,
                          np.asarray(img.shape, np.float32) - np.asarray(crop)
                          ).astype(np.float32)
            win = tuple(slice(int(o), int(o) + c) for o, c in zip(off, crop))
            pts, ids = s["points"] - off[None, :], s["ids"]
            inside = (ids > 0) & np.all((pts >= 0) & (pts < np.asarray(crop, np.float32)),
                                        axis=1)
            frac = sparse_target_fg_fraction({1: pts[inside]} if inside.any() else {},
                                             crop, dist_thr, aniso)
            if frac is None:
                continue
            x = torch.from_numpy(np.ascontiguousarray(img[win]))[None, ..., None].to(dev)
            out = model((x - mean) / std)
            calibrate.forwards += 1
            probs.append(out[..., 4].float().cpu().numpy().ravel())
            fracs.append(frac)
        if not fracs:
            return None
        return calibrate_semantic_threshold(np.concatenate(probs), float(np.mean(fracs)))

    calibrate.forwards = 0
    return calibrate


def swa_update(avg: Optional[Dict[str, torch.Tensor]], model: torch.nn.Module,
               n: int) -> Dict[str, torch.Tensor]:
    """The running mean after its ``n``-th member (``n = 1`` copies the
    weights): ``avg + (new - avg) / n``, in each parameter's dtype."""
    new = {k: v.detach() for k, v in model.state_dict().items()}
    if avg is None:
        return {k: v.clone() for k, v in new.items()}
    return {k: avg[k] + (new[k] - avg[k]) / n for k in avg}


@dataclass
class SparseTrainState(TrainState):
    """:class:`TrainState` plus what the checkpoint holds: ``saved_model``
    (the SWA average once it started, else the trained model), the
    calibrated threshold (None when no window had points) and the
    calibrator's forwards."""

    saved_model: torch.nn.Module
    calibrated_prob_threshold: Optional[float]
    calibration_forwards: int


class _Multi:
    """JAX's uniform draw over the datasets, then a sample of the drawn one."""

    def __init__(self, datasets: List[SparseDataset]):
        self.datasets = datasets

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def sample(self, rng: np.random.Generator):
        return self.datasets[rng.integers(len(self.datasets))].sample(rng)


def _check_dist_thr(cfg: dict, records: Sequence[SparseRecord]) -> None:
    """Warn when ``DIST_THR`` is more than 2x from half the least spacing of
    different instances' skeleton points (the data-derived suggestion)."""
    suggestions = [s for r in records
                   for s in [suggest_dist_thr_from_points(r.skeletons)] if s is not None]
    if not suggestions:
        return
    sugg = float(np.median(suggestions))
    thr = float(cfg["EXPERIMENTAL"]["DIST_THR"])
    if thr > 2 * sugg or thr < sugg / 2:
        log.warning("EXPERIMENTAL.DIST_THR=%.1f is far from the data-derived suggestion "
                    "%.1f (half the minimum inter-instance skeleton spacing): too large "
                    "pulls voxels toward other instances' skeletons, too small starves "
                    "supervision", thr, sugg)
    else:
        log.info("DIST_THR=%.1f (data-derived suggestion: %.1f)", thr, sugg)


def train_sparse(cfg: dict, steps_per_epoch: Optional[int] = None, device="cuda",
                 records: Optional[Sequence[SparseRecord]] = None) -> SparseTrainState:
    """Sparse training on ``device`` (default ``cuda``; nothing falls back
    to the CPU) for ``TRAIN.NUM_EPOCHS`` epochs from a seeded fresh init,
    on the ``TRAIN.TRAIN_DATA_DIR`` directories or, when given, the
    in-memory ``records`` (sampled ``TRAIN_SAMPLE_PER_IMAGE[0]`` times a
    volume, else once). Saves ``SAVE_PATH/<time>_sparse.skoots`` every
    ``SAVE_INTERVAL`` epochs and after the last, with the SWA average where
    it started, the optimizer state (as JAX saves it, after the updates
    applied so far) and ``extra`` = {epoch, swa, calibrated_prob_threshold}."""
    t = cfg["TRAIN"]
    device = torch.device(device)
    if records is not None:
        spi = t["TRAIN_SAMPLE_PER_IMAGE"][0] if t["TRAIN_SAMPLE_PER_IMAGE"] else 1
        datasets = [SparseDataset(list(records), cfg, sample_per_image=spi)]
    else:
        datasets = [SparseDataset(d, cfg, sample_per_image=s)
                    for d, s in zip(t["TRAIN_DATA_DIR"], t["TRAIN_SAMPLE_PER_IMAGE"])]
    recs = [r for d in datasets for r in d.records]
    if not recs:
        raise FileNotFoundError("sparse training needs TRAIN.TRAIN_DATA_DIR or records")
    mean = float(np.mean([r.image.mean() for r in recs]))
    std = float(np.mean([r.image.std() for r in recs])) or 1.0
    _check_dist_thr(cfg, recs)

    dataset = _Multi(datasets)
    bsz = t["TRAIN_BATCH_SIZE"]
    steps = steps_per_epoch or max(1, len(dataset) // bsz)
    host_iter = prefetch_iterator(batch_iterator(dataset, bsz, steps, t["SEED"]))
    augment = make_sparse_augment(cfg, mean, std, device)

    model = init_model(cfg, t["SEED"], device=device).train()
    optimizer, schedule = cfg_optimizer(cfg, model.parameters())
    step_fn = make_sparse_train_step(model, optimizer, schedule, init_sigma(cfg), cfg)
    calibrate = make_threshold_calibrator(cfg, dataset, mean, std)
    swa_model = cfg_to_model(cfg, device)

    epochs = t["NUM_EPOCHS"]
    swa_start = int(epochs * 0.75)
    swa, swa_n = None, 0
    os.makedirs(t["SAVE_PATH"], exist_ok=True)
    save_name = os.path.join(t["SAVE_PATH"], time.strftime("%b%d_%H-%M-%S") + "_sparse.skoots")
    n_steps, n_skipped, means, sem_thr, saved = 0, 0, {}, None, model
    for e in range(epochs):
        t0 = time.time()
        gen = torch.Generator().manual_seed(t["SEED"] + e)
        agg: Dict[str, list] = {}
        for host_batch in host_iter(e):
            metrics = step_fn(augment(host_batch, gen), e)
            n_steps += 1
            n_skipped += bool(metrics.get("skipped", False))
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        means = {k: float(np.mean([float(v) for v in vs])) for k, vs in agg.items()}
        log.info("sparse epoch %d: %s (%.2fs)", e, means, time.time() - t0)
        if e >= swa_start:
            swa_n += 1
            swa = swa_update(swa, model, swa_n)
        if (e + 1) % t["SAVE_INTERVAL"] == 0 or e == epochs - 1:
            saved = model
            if swa is not None:
                swa_model.load_state_dict(swa)
                saved = swa_model
            sem_thr = calibrate(saved.eval())
            model.train()
            if sem_thr is not None:
                log.info("calibrated semantic threshold: %.6f", sem_thr)
            save_checkpoint(save_name, cfg, saved.state_dict(),
                            flax_opt_state(optimizer, model, cfg, n_steps - n_skipped),
                            dataset_mean=mean, dataset_std=std,
                            extra={"epoch": e, "swa": swa is not None,
                                   "calibrated_prob_threshold": sem_thr})
            log.info("checkpoint -> %s", save_name)
    return SparseTrainState(model, optimizer, n_steps, save_name, means, saved, sem_thr,
                            calibrate.forwards)
