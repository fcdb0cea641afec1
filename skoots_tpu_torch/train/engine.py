"""Training engine (port of ``skoots_tpu/train/engine.py``): the optimizer
and its per-epoch learning rate, the train and eval steps, and the epoch
loop.

One device, explicit: nothing here moves to the CPU when no GPU is found;
or, with ``mesh=`` (``parallel/mesh.py``), data-parallel over the mesh's
data rows from this one process, as JAX's single-controller step: the
parameters and the optimizer live on the first device, each row's slice of
the batch runs through ``torch.func.functional_call`` with the parameters
copied to its device, the outputs come back to the first device and the
loss is computed once, on the whole batch (so a whole-batch loss such as
``dice`` equals the one-device step's), autograd carries the gradients
back and the update is made once. The space axis, whose replicas change
nothing in JAX, is computed once a row. A train step is the model forward and the loss stack (:func:`make_train_step`'s
``loss_fn``), ``loss.backward()`` through the kernels' autograd wrappers,
and the optimizer update (``apply_update``); the three are public so a
caller can time them apart. The loss stack, the strict-``>`` epoch gating
and the sigma annealing are the JAX package's. DropPath's masks come from a
``torch.Generator`` seeded from ``TRAIN.SEED`` and the step
(:func:`drop_path_generator`), where JAX folds the step into its key.

The optimizer state travels in checkpoints as JAX writes it: the flax state
dict of optax's ``inject_hyperparams(<optimizer>)`` state
(:func:`flax_opt_state`, :func:`load_flax_opt_state`), so either package
resumes from the other's file with ``LOAD_PRETRAINED_OPTIMIZER``.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from skoots_tpu_torch.checkpoint import (
    flax_params_from_torch,
    load_checkpoint,
    save_checkpoint,
    torch_params_from_flax,
)
from skoots_tpu_torch.models import init_model, load_flax_params
from skoots_tpu_torch.models.unext import ConvNeXtBlock3D, DropPathMasks
from skoots_tpu_torch.ops.embed2prob import baked_embed_to_prob
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.train.losses import cfg_loss
from skoots_tpu_torch.train.sigma import Sigma, init_sigma
from skoots_tpu_torch.train.viz import write_progress
from skoots_tpu_torch.utils import trace

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


# optax moment name -> torch state key, per optimizer
_MOMENTS = {"adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
            "adamax": {"mu": "exp_avg", "nu": "exp_inf"},
            "sgd": {"trace": "momentum_buffer"}}


def _opt_layout(cfg: dict) -> tuple[str, bool]:
    """(optimizer name, whether SGD carries a momentum trace)."""
    t = cfg["TRAIN"]
    return t["OPTIMIZER"].lower(), "momentum" in t["OPTIMIZER_KEYWORD_ARGUMENTS"]


def flax_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module, cfg: dict,
                   count: int) -> dict:
    """The optimizer's state as the flax state dict of the JAX package's
    ``inject_hyperparams(<optax optimizer>)`` state after ``count`` updates,
    which JAX's ``restore_params(optimizer.init(params), ...)`` reads:
    ``{'count', 'hyperparams', 'hyperparams_states': {}, 'inner_state'}``
    with the moments keyed by the flax parameter names in flax layout.

    * AdamW / Adam / Adamax: ``inner_state['0']`` = ``{'count', 'mu', 'nu'}``
      (mu = ``exp_avg``, nu = ``exp_avg_sq``, or Adamax's ``exp_inf``: torch
      and optax 0.2.6 both keep ``max(b2 * nu, |g| + eps)``); then one empty
      state per further transform (AdamW's weight decay, the lr scale).
      Hyperparams b1, b2, eps, eps_root (Adam, AdamW; 0), learning_rate,
      weight_decay (AdamW).
    * SGD: ``inner_state['0']`` = ``{'trace': momentum_buffer}`` when the cfg
      names a momentum, else ``{}``; hyperparams learning_rate (momentum).

    Every leaf is a 0-d or parameter-shaped numpy array (f32, counts
    int32), as ``flax.serialization.to_state_dict`` gives them."""
    name, has_trace = _opt_layout(cfg)
    if name not in _MOMENTS:
        raise RuntimeError(f"unknown optimizer {name!r}")
    group = optimizer.param_groups[0]
    names = {id(p): n for n, p in model.named_parameters()}
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731

    def tree(key: str) -> dict:
        out = {}
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            out[names[id(p)]] = st[key] if st.get(key) is not None else torch.zeros_like(p)
        return flax_params_from_torch(out)

    hp = {"learning_rate": f32(group["lr"])}
    if name == "sgd":
        if has_trace:
            hp["momentum"] = f32(group["momentum"])
        inner = {"0": {"trace": tree("momentum_buffer")} if has_trace else {}, "1": {}}
    else:
        b1, b2 = group["betas"]
        hp.update(b1=f32(b1), b2=f32(b2), eps=f32(group["eps"]))
        if name != "adamax":
            hp["eps_root"] = f32(0.0)
        moments = _MOMENTS[name]
        inner = {"0": {"count": np.asarray(count, np.int32),
                       **{k: tree(v) for k, v in moments.items()}}, "1": {}}
        if name == "adamw":
            hp["weight_decay"] = f32(group["weight_decay"])
            inner["2"] = {}
    return {"count": np.asarray(count, np.int32), "hyperparams": hp,
            "hyperparams_states": {}, "inner_state": inner}


def load_flax_opt_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                        cfg: dict, state: dict) -> int:
    """Restore a checkpoint's ``opt_state`` (:func:`flax_opt_state`'s layout,
    as either package writes it) into ``optimizer``: the moments, the step
    count and the hyperparams other than the learning rate (which the
    schedule sets every step), as JAX's ``restore_params`` takes them from
    the file. Returns the update count."""
    name, has_trace = _opt_layout(cfg)
    group = optimizer.param_groups[0]
    hp = state["hyperparams"]
    inner = state["inner_state"]["0"]
    moments = {v: torch_params_from_flax(inner[k]) for k, v in _MOMENTS[name].items()
               if name != "sgd" or has_trace}
    if name == "sgd":
        if has_trace:
            group["momentum"] = float(hp["momentum"])
    else:
        group["betas"] = (float(hp["b1"]), float(hp["b2"]))
        group["eps"] = float(hp["eps"])
        if name == "adamw":
            group["weight_decay"] = float(hp["weight_decay"])
    step = int(inner.get("count", state["count"]))
    for n, p in model.named_parameters():
        st = optimizer.state[p]
        for key, values in moments.items():
            if values[n].shape != p.shape:
                raise ValueError(f"opt_state {key} of {n}: {tuple(values[n].shape)} "
                                 f"against {tuple(p.shape)}")
            st[key] = values[n].to(p.device, p.dtype).clone()
        if name != "sgd":
            st["step"] = torch.tensor(float(step))
    return int(state["count"])


def drop_path_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of training step ``step``'s DropPath masks, seeded
    from (``TRAIN.SEED``, step) through numpy's ``SeedSequence``."""
    hi, lo = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


def _losses(cfg: dict):
    t = cfg["TRAIN"]
    return tuple(cfg_loss(t[n], t[f"{n}_KEYWORDS"], t[f"{n}_VALUES"])
                 for n in ("LOSS_EMBED", "LOSS_PROBABILITY", "LOSS_SKELETON"))


def _loss_terms(model, batch, sigma_value, vector_scale, losses, drop_gen=None,
                forward=None):
    out = (forward or model)(batch["image"], drop_gen)
    vec, skel, prob = out[..., 0:3], out[..., 3:4], out[..., 4:5]
    embedding = vector_to_embedding(vector_scale, vec)
    embed_prob = baked_embed_to_prob(embedding, batch["baked"], sigma_value)
    gt_fg = (batch["masks"] > 0).float()
    gt_skel = (batch["skele_masks"] > 0).float()
    loss_embed, loss_prob, loss_skele = losses
    return loss_embed(embed_prob, gt_fg), loss_prob(prob, gt_fg), loss_skele(skel, gt_skel)


def data_parallel_forward(model, mesh):
    """``forward(image, drop_gen) -> out``: the model on each of the mesh's
    data rows' slice of the batch (``batch_sharding``), with the
    parameters copied to the row's device (differentiably), the outputs
    concatenated on the first device. DropPath's masks are drawn for the
    whole batch, in block order, then sliced per row
    (:class:`~skoots_tpu_torch.models.unext.DropPathMasks`), so the rows
    drop what one forward of the whole batch would."""
    from skoots_tpu_torch.parallel import batch_sharding

    first = mesh.devices[0][0]
    blocks = sum(isinstance(m, ConvNeXtBlock3D) for m in model.modules())
    rate = float(getattr(model.backbone, "drop_path_rate", 0.0))

    def forward(image, drop_gen=None):
        pieces = batch_sharding(mesh, image)
        if drop_gen is not None and model.training and rate > 0:
            drop_gen = DropPathMasks.draw(drop_gen, blocks, image.shape[0], rate)
        outs, start = [], 0
        for piece, row in zip(pieces, mesh.devices):
            dev = row[0]
            state = {n: t.to(dev) for n, t in model.named_parameters()}
            state.update({n: t.to(dev) for n, t in model.named_buffers()})
            gen = drop_gen.shard(start, piece.shape[0]) \
                if isinstance(drop_gen, DropPathMasks) else drop_gen
            out = torch.func.functional_call(model, state, (piece, gen))
            outs.append(out.to(first))
            start += piece.shape[0]
        return torch.cat(outs, 0)

    return forward


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], sigma: Sigma, cfg: dict,
                    mesh=None):
    """``step(batch, epoch) -> metrics``: one forward, backward and update
    of ``model`` (in train mode). Batch (channels-last, on the model's
    device): image ``[B, X, Y, Z, 1]`` f32 normalised, masks and
    skele_masks ``[B, X, Y, Z, 1]`` f32, baked ``[B, X, Y, Z, 3]`` f32.
    Metrics: loss, embed, prob, skele (0-d tensors) and lr. A call is the
    root span ``train.step``, its forward and loss, backward and update the
    spans ``train.forward``, ``train.backward``, ``train.optimizer``. With
    ``MODEL.DROP_PATH_RATE`` > 0 the n-th call (from 0) draws its DropPath
    masks from ``drop_path_generator(TRAIN.SEED, n)``; ``loss_fn(batch,
    epoch, drop_gen=None)`` takes the generator explicitly. ``mesh``: the
    data-parallel forward (:func:`data_parallel_forward`; ``model`` on the
    mesh's first device, the batch anywhere)."""
    t = cfg["TRAIN"]
    vector_scale = tuple(float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"])
    losses = _losses(cfg)
    weights = (t["LOSS_EMBED_RELATIVE_WEIGHT"], t["LOSS_PROBABILITY_RELATIVE_WEIGHT"],
               t["LOSS_SKELETON_RELATIVE_WEIGHT"])
    starts = (t["LOSS_EMBED_START_EPOCH"], t["LOSS_PROBABILITY_START_EPOCH"],
              t["LOSS_SKELETON_START_EPOCH"])

    seed, drop = int(t["SEED"]), float(cfg["MODEL"]["DROP_PATH_RATE"]) > 0
    calls = [0]
    forward = data_parallel_forward(model, mesh) if mesh is not None else None

    def loss_fn(batch, epoch: int, drop_gen: Optional[torch.Generator] = None):
        terms = _loss_terms(model, batch, sigma(epoch), vector_scale, losses, drop_gen,
                            forward)
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

    @trace.spanned("train.step", root=True)
    def step(batch, epoch: int) -> Dict[str, Any]:
        gen = drop_path_generator(seed, calls[0]) if drop else None
        calls[0] += 1
        optimizer.zero_grad(set_to_none=True)
        with trace.span("train.forward"):
            total, metrics = loss_fn(batch, epoch, gen)
        with trace.span("train.backward"):
            total.backward()
        with trace.span("train.optimizer"):
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
    mesh=None,
) -> TrainState:
    """Train a freshly initialised model (weights from ``TRAIN.SEED``, or a
    pretrained checkpoint) on ``device`` for ``TRAIN.NUM_EPOCHS`` epochs.
    ``data_iter(epoch)`` yields device batches (:func:`make_train_step`).
    Saves a ``.skoots`` checkpoint (parameters and optimizer state) every
    ``SAVE_INTERVAL`` epochs and after the last; ``LOAD_PRETRAINED_OPTIMIZER``
    with a pretrained checkpoint resumes its optimizer state. With a ``writer`` (TensorBoard's ``SummaryWriter`` API), each
    epoch logs the mean losses and lr as scalars and one ``"Train"`` image
    of panels from an eval forward on the epoch's last batch
    (:func:`write_panels`), as the JAX loop does. ``AUTOGRAD_PROFILE``
    records a ``torch.profiler`` trace to ``SAVE_PATH/torch_trace/trace.json``
    with the program's spans and host syncs (``utils/trace.py``) on its
    timeline, then drops them from memory (``trace.reset``);
    ``AUTOGRAD_EMIT_NVTX`` runs the loop under
    ``torch.autograd.profiler.emit_nvtx`` (ranges for an external CUDA
    profiler; the program's spans do not record there), and the two
    together raise ``ValueError``; ``AUTOGRAD_DETECT_ANOMALY``
    turns on ``torch.autograd.set_detect_anomaly``. ``mesh``: train data-parallel
    over its data rows (:func:`make_train_step`); the model, the optimizer,
    validation and the panels then live on its first device."""
    t = cfg["TRAIN"]
    if t["AUTOGRAD_PROFILE"] and t["AUTOGRAD_EMIT_NVTX"]:
        raise ValueError("TRAIN.AUTOGRAD_PROFILE and TRAIN.AUTOGRAD_EMIT_NVTX are two "
                         "profilers and cannot run together; set one")
    device = mesh.devices[0][0] if mesh is not None else torch.device(device)
    model = init_model(cfg, t["SEED"], device=device).train()
    ckpt = None
    if t["PRETRAINED_MODEL_PATH"]:
        ckpt = load_checkpoint(t["PRETRAINED_MODEL_PATH"][0])
        load_flax_params(model, ckpt["params"])
        log.info("loaded pretrained params from %s", t["PRETRAINED_MODEL_PATH"][0])

    optimizer, schedule = cfg_optimizer(cfg, model.parameters())
    count0 = 0
    if ckpt is not None and t["LOAD_PRETRAINED_OPTIMIZER"] and ckpt.get("opt_state") is not None:
        count0 = load_flax_opt_state(optimizer, model, cfg, ckpt["opt_state"])
        log.info("restored the optimizer state (%d updates)", count0)
    sigma = init_sigma(cfg)
    train_step = make_train_step(model, optimizer, schedule, sigma, cfg, mesh)
    eval_step = make_eval_step(model, sigma, cfg) if val_iter else None
    vector_scale = tuple(float(v) for v in cfg["SKOOTS"]["VECTOR_SCALING"])

    os.makedirs(t["SAVE_PATH"], exist_ok=True)
    save_name = os.path.join(t["SAVE_PATH"], time.strftime("%b%d_%H-%M-%S") + ".skoots")

    anomaly = torch.autograd.set_detect_anomaly(bool(t["AUTOGRAD_DETECT_ANOMALY"]))
    nvtx = torch.autograd.profiler.emit_nvtx(enabled=bool(t["AUTOGRAD_EMIT_NVTX"]))
    nvtx.__enter__()
    prof = None
    if t["AUTOGRAD_PROFILE"]:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        since_ns = time.time_ns()
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
                                flax_opt_state(optimizer, model, cfg, count0 + steps),
                                dataset_mean=dataset_mean, dataset_std=dataset_std,
                                extra={"epoch": e, "object_radius": object_radius})
                log.info("checkpoint -> %s", save_name)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            trace_dir = os.path.join(t["SAVE_PATH"], "torch_trace")
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(path)
            trace.export_chrome(path, since_ns)
            trace.reset()
            log.info("profiler trace written to %s", trace_dir)
        nvtx.__exit__(None, None, None)
        anomaly.__exit__(None, None, None)
    return TrainState(model, optimizer, steps, save_name, means)
