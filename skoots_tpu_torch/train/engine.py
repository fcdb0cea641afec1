"""Training engine (port of ``skoots_tpu/train/engine.py``): the optimizer
and its per-epoch learning rate, the train and eval steps, and the epoch
loop.

One device, explicit: nothing here moves to the CPU when no GPU is found.
A train step is the model forward and the loss stack (:func:`make_train_step`'s
``loss_fn``), ``loss.backward()`` through the kernels' autograd wrappers,
and the optimizer update (``apply_update``); the three are public so a
caller can time them apart. The loss stack, the strict-``>`` epoch gating
and the sigma annealing are the JAX package's.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from skoots_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from skoots_tpu_torch.models import init_model, load_flax_params
from skoots_tpu_torch.ops.embed2prob import baked_embed_to_prob
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.train.losses import cfg_loss
from skoots_tpu_torch.train.sigma import Sigma, init_sigma
from skoots_tpu_torch.train.viz import write_progress

log = logging.getLogger(__name__)


def warm_restart_lr(base_lr: float, t0: int, epoch: int) -> float:
    """Cosine annealing with warm restarts, stepped per epoch, in f32 as the
    JAX schedule computes it."""
    t = np.float32(epoch % t0)
    f32 = np.float32
    return float(f32(base_lr) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t / f32(t0))))


# optax keyword -> (torch keyword, position in a tuple keyword or None)
_KWARG_MAP = {"b1": ("betas", 0), "b2": ("betas", 1), "momentum": ("momentum", None),
              "nesterov": ("nesterov", None)}


def cfg_optimizer(cfg: dict, params) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """``(optimizer, schedule)``: ``torch.optim`` AdamW / Adam / SGD /
    Adamax over ``params`` in ONE parameter group (so AdamW's decoupled
    decay ``lr * wd * p`` reaches every parameter, as optax's does), and
    ``schedule(epoch) -> lr``. ``OPTIMIZER_KEYWORD_ARGUMENTS`` use optax's
    names (``b1``, ``b2``, ``momentum``, ``nesterov``)."""
    t = cfg["TRAIN"]
    lr, wd, eps = float(t["LEARNING_RATE"]), float(t["WEIGHT_DECAY"]), float(t["OPTIMIZER_EPS"])
    name = t["OPTIMIZER"].lower()
    kwargs: Dict[str, Any] = {}
    for k, v in zip(t["OPTIMIZER_KEYWORD_ARGUMENTS"], t["OPTIMIZER_KEYWORD_VALUES"]):
        if k not in _KWARG_MAP:
            raise ValueError(f"optimizer keyword {k!r} is not ported; known: {list(_KWARG_MAP)}")
        tk, pos = _KWARG_MAP[k]
        if pos is None:
            kwargs[tk] = v
        else:
            betas = list(kwargs.get(tk, (0.9, 0.999)))
            betas[pos] = float(v)
            kwargs[tk] = tuple(betas)
    if name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=wd, eps=eps, **kwargs)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=lr, eps=eps, **kwargs)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, **kwargs)
    elif name == "adamax":
        opt = torch.optim.Adamax(params, lr=lr, eps=eps, **kwargs)
    else:
        raise RuntimeError(f"unknown optimizer {name!r}")
    if t["SCHEDULER"] == "cosine_annealing_warm_restarts":
        t0 = int(t["SCHEDULER_T0"])

        def schedule(epoch: int) -> float:
            return warm_restart_lr(lr, t0, epoch)
    else:
        def schedule(epoch: int) -> float:
            return lr
    return opt, schedule


def _losses(cfg: dict):
    t = cfg["TRAIN"]
    return tuple(cfg_loss(t[n], t[f"{n}_KEYWORDS"], t[f"{n}_VALUES"])
                 for n in ("LOSS_EMBED", "LOSS_PROBABILITY", "LOSS_SKELETON"))


def _loss_terms(model, batch, sigma_value, vector_scale, losses):
    out = model(batch["image"])
    vec, skel, prob = out[..., 0:3], out[..., 3:4], out[..., 4:5]
    embedding = vector_to_embedding(vector_scale, vec)
    embed_prob = baked_embed_to_prob(embedding, batch["baked"], sigma_value)
    gt_fg = (batch["masks"] > 0).float()
    gt_skel = (batch["skele_masks"] > 0).float()
    loss_embed, loss_prob, loss_skele = losses
    return loss_embed(embed_prob, gt_fg), loss_prob(prob, gt_fg), loss_skele(skel, gt_skel)


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], sigma: Sigma, cfg: dict):
    """``step(batch, epoch) -> metrics``: one forward, backward and update
    of ``model`` (in train mode). Batch (channels-last, on the model's
    device): image ``[B, X, Y, Z, 1]`` f32 normalised, masks and
    skele_masks ``[B, X, Y, Z, 1]`` f32, baked ``[B, X, Y, Z, 3]`` f32.
    Metrics: loss, embed, prob, skele (0-d tensors) and lr."""
    t = cfg["TRAIN"]
    vector_scale = tuple(float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"])
    losses = _losses(cfg)
    weights = (t["LOSS_EMBED_RELATIVE_WEIGHT"], t["LOSS_PROBABILITY_RELATIVE_WEIGHT"],
               t["LOSS_SKELETON_RELATIVE_WEIGHT"])
    starts = (t["LOSS_EMBED_START_EPOCH"], t["LOSS_PROBABILITY_START_EPOCH"],
              t["LOSS_SKELETON_START_EPOCH"])

    def loss_fn(batch, epoch: int):
        terms = _loss_terms(model, batch, sigma(epoch), vector_scale, losses)
        # epoch gating, strict >: a gated-off term still enters times 0
        total = sum(w * float(epoch > e0) * term
                    for w, e0, term in zip(weights, starts, terms))
        names = ("embed", "prob", "skele")
        return total, {"loss": total.detach(),
                       **{n: term.detach() for n, term in zip(names, terms)}}

    def apply_update(epoch: int) -> float:
        lr = schedule(epoch)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return lr

    def step(batch, epoch: int) -> Dict[str, Any]:
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, epoch)
        total.backward()
        metrics["lr"] = apply_update(epoch)
        return metrics

    step.loss_fn = loss_fn
    step.apply_update = apply_update
    return step


def make_eval_step(model, sigma: Sigma, cfg: dict):
    """``eval_step(batch, epoch) -> {embed, prob, skele}``, no gradients,
    the model in eval mode for the call."""
    vector_scale = tuple(float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"])
    losses = _losses(cfg)

    @torch.no_grad()
    def eval_step(batch, epoch: int):
        was_training = model.training
        model.eval()
        try:
            terms = _loss_terms(model, batch, sigma(epoch), vector_scale, losses)
        finally:
            model.train(was_training)
        return dict(zip(("embed", "prob", "skele"), terms))

    return eval_step


@torch.no_grad()
def panel_forward(model, batch, sigma_value, vector_scale):
    """JAX's ``_panel_forward``: the model in eval mode on ``batch["image"]``,
    its output split as :func:`_loss_terms` splits it, and the embedding's
    probability against ``batch["baked"]`` at ``sigma_value``. Returns
    (vectors, skeleton, probability), channels last."""
    was_training = model.training
    model.eval()
    try:
        out = model(batch["image"])
    finally:
        model.train(was_training)
    vec, skel = out[..., 0:3], out[..., 3:4]
    prob = baked_embed_to_prob(vector_to_embedding(vector_scale, vec), batch["baked"],
                               sigma_value)
    return vec, skel, prob


def write_panels(writer, model, batch, sigma_value, vector_scale, epoch: int) -> None:
    """The epoch's ``"Train"`` image panels (JAX's dense loop): one eval
    forward on ``batch``, then :func:`~skoots_tpu_torch.train.viz.write_progress`."""
    vec, skel, prob = panel_forward(model, batch, sigma_value, vector_scale)

    def host(t):
        return t.detach().float().cpu().numpy()

    write_progress(writer, "Train", epoch, images=host(batch["image"]),
                   masks=host(batch["masks"]), vector=host(vec), embed_prob=host(prob),
                   predicted_skeleton=host(skel), gt_skeleton=host(batch["skele_masks"]))


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    save_name: str
    epoch_means: Dict[str, float]


def train(
    cfg: dict,
    data_iter: Callable[[int], Any],
    device,
    val_iter: Optional[Callable[[int], Any]] = None,
    dataset_mean: float = 0.0,
    dataset_std: float = 1.0,
    writer=None,
    object_radius: Optional[float] = None,
) -> TrainState:
    """Train a freshly initialised model (weights from ``TRAIN.SEED``, or a
    pretrained checkpoint) on ``device`` for ``TRAIN.NUM_EPOCHS`` epochs.
    ``data_iter(epoch)`` yields device batches (:func:`make_train_step`).
    Saves a ``.skoots`` checkpoint every ``SAVE_INTERVAL`` epochs and after
    the last. With a ``writer`` (TensorBoard's ``SummaryWriter`` API), each
    epoch logs the mean losses and lr as scalars and one ``"Train"`` image
    of panels from an eval forward on the epoch's last batch
    (:func:`write_panels`), as the JAX loop does. ``AUTOGRAD_PROFILE``
    records a ``torch.profiler`` trace to ``SAVE_PATH/torch_trace``;
    ``AUTOGRAD_DETECT_ANOMALY`` turns on
    ``torch.autograd.set_detect_anomaly``."""
    t = cfg["TRAIN"]
    device = torch.device(device)
    model = init_model(cfg, t["SEED"], device=device).train()
    if t["PRETRAINED_MODEL_PATH"]:
        ckpt = load_checkpoint(t["PRETRAINED_MODEL_PATH"][0])
        load_flax_params(model, ckpt["params"])
        log.info("loaded pretrained params from %s", t["PRETRAINED_MODEL_PATH"][0])
        if t["LOAD_PRETRAINED_OPTIMIZER"] and ckpt.get("opt_state") is not None:
            raise NotImplementedError(
                "restoring an optimizer state from a checkpoint is not ported "
                "yet (see ROADMAP.md)")

    optimizer, schedule = cfg_optimizer(cfg, model.parameters())
    sigma = init_sigma(cfg)
    train_step = make_train_step(model, optimizer, schedule, sigma, cfg)
    eval_step = make_eval_step(model, sigma, cfg) if val_iter else None
    vector_scale = tuple(float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"])

    os.makedirs(t["SAVE_PATH"], exist_ok=True)
    save_name = os.path.join(t["SAVE_PATH"], time.strftime("%b%d_%H-%M-%S") + ".skoots")

    anomaly = torch.autograd.set_detect_anomaly(bool(t["AUTOGRAD_DETECT_ANOMALY"]))
    prof = None
    if t["AUTOGRAD_PROFILE"]:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    steps = 0
    means: Dict[str, float] = {}
    try:
        for e in range(t["NUM_EPOCHS"]):
            t0 = time.time()
            agg: Dict[str, list] = {}
            last_batch = None
            for batch in data_iter(e):
                last_batch = batch
                metrics = train_step(batch, e)
                steps += 1
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(v)
            means = {k: float(np.mean([float(v) for v in vs])) for k, vs in agg.items()}
            log.info("epoch %d: %s (%.2fs)", e, means, time.time() - t0)
            if writer is not None:
                for k, v in means.items():
                    writer.add_scalar(f"Loss/{k}" if k != "lr" else "lr", v, e)
                if last_batch is not None:
                    write_panels(writer, model, last_batch, sigma(e), vector_scale, e)

            if eval_step is not None and e % t["VALIDATE_EPOCH_SKIP"] == 0:
                vagg: Dict[str, list] = {}
                for batch in val_iter(e):
                    for k, v in eval_step(batch, e).items():
                        vagg.setdefault(k, []).append(float(v))
                vmeans = {k: float(np.mean(vs)) for k, vs in vagg.items()}
                log.info("epoch %d validation: %s", e, vmeans)
                if writer is not None:
                    for k, v in vmeans.items():
                        writer.add_scalar(f"Validation/{k}", v, e)

            if (e + 1) % t["SAVE_INTERVAL"] == 0 or e == t["NUM_EPOCHS"] - 1:
                save_checkpoint(save_name, cfg, model.state_dict(),
                                dataset_mean=dataset_mean, dataset_std=dataset_std,
                                extra={"epoch": e, "object_radius": object_radius})
                log.info("checkpoint -> %s", save_name)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            trace = os.path.join(t["SAVE_PATH"], "torch_trace")
            os.makedirs(trace, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace, "trace.json"))
            log.info("profiler trace written to %s", trace)
        anomaly.__exit__(None, None, None)
    return TrainState(model, optimizer, steps, save_name, means)
