"""Dense training steps on the card, back to back.

The unit is one step of the training CLI's dense loop
(``train/cli.py::run_config`` feeding ``train/engine.py::train``): a host
batch from ``SkootsDataset`` through ``MultiDataset``, ``batch_iterator`` and
``prefetch_iterator``, ``make_batch_augment`` on the card (the bake
included), and ``make_train_step``'s forward, loss, backward and AdamW
update, at the configuration's cfg (the reference's defaults). No
checkpoint saves, panels or validation.

Set-up builds the records from the seed, the dataset, the model with
weights from the seed (``benchmark/weights.py``), the optimizer and the
step, then drives that same step through its first ``judged_steps`` steps
(recording each loss, the optimizer's first moments after step 1 and the
parameters after the last), then ``warmup`` more. The window runs whole
steps until ``--seconds`` have passed, recording a CUDA event on the stream
at the start of each step; with ``--trace 1`` also events around the
augmentation.

Correctness: after the window, with the program freed, the reference
(``reference/train.py``) replays the first steps from the same records,
seed and weights in f32, and judges:

* ``grad_gap``: the first gradient as the optimizer got it (AdamW's first
  moment after one step over ``1 - beta1``), worst leaf, the gap of the
  norms over the larger of the reference's norm of that leaf and of the
  median leaf;
* ``update_gap``: the parameters' change over the judged steps, the same
  measure;
* ``grad_diff`` and ``update_diff``: the same two, worst leaf, as the norm
  of the program's difference from the reference over the same
  denominator, which also sees a direction gone wrong.

Leaves whose reference gradient is below a thousandth of the median leaf's
are left out of both (``reference/train.py::moved_leaves``). The judged
steps' losses, |program - reference| / |reference| a step, are printed but
not compared: the first step's has no control or fault that separates it
from sound runs, and the later steps' carry the drift of the updates
(PERF.md, section 2).
"""

from __future__ import annotations

import time


def _setup_cfg(config: dict, seed: int):
    from skoots_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    for section, values in config["cfg"].items():
        for k, v in values.items():
            cfg[section][k] = v
    cfg["TRAIN"]["SEED"] = int(seed)
    return cfg


def run(ctx):
    import torch

    from skoots_tpu_torch.models import cfg_to_model
    from skoots_tpu_torch.train.data import (
        MultiDataset,
        SkootsDataset,
        VolumeRecord,
        batch_iterator,
        prefetch_iterator,
    )
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.train.transforms import make_batch_augment

    from benchmark import weights
    from benchmark.harness import Trace, report

    dev = ctx.device
    wl, mix = ctx.workload, ctx.mix
    fault = getattr(ctx, "fault", None)
    seed = ctx.seed % (2**31)
    cfg = _setup_cfg(ctx.config, seed)
    epoch = int(mix["epoch"])
    cfg["TRAIN"]["TRAIN_BATCH_SIZE"] = int(mix["batch"])
    records = ctx.generator.make(mix, ctx.seed, dev)
    ctx.mark(f"{len(records)} records made")
    dataset = MultiDataset([SkootsDataset(
        [VolumeRecord(r["image"], r["masks"], r["skeletons"]) for r in records], cfg)])
    A = cfg["AUGMENTATION"]
    mean, std = dataset.mean_std(with_invert=A.get("INVERT_RATE", A["BRIGHTNESS_RATE"]) > 0)
    host_iter = prefetch_iterator(batch_iterator(dataset, int(mix["batch"]), 1 << 30, seed))
    augment = make_batch_augment(cfg, mean, std, intensity_ceiling=dataset.intensity_ceiling(),
                                 device=dev)

    ctx.mark("dataset, statistics and augmentation built")
    model = cfg_to_model(cfg, dev).train()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params0 = weights.make(shapes, ctx.seed, cfg["MODEL"]["LAYER_SCALE_INIT_VALUE"], dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params0[n])
    optimizer, schedule = cfg_optimizer(cfg, model.parameters())
    if fault == "unchanged":
        optimizer.step = lambda *a, **k: None
    elif fault == "flipped":
        step_as_built = optimizer.step

        def flipped(*a, **k):
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.neg_()
            return step_as_built(*a, **k)

        optimizer.step = flipped
    step = make_train_step(model, optimizer, schedule, init_sigma(cfg), cfg)
    gen = torch.Generator().manual_seed(seed + epoch)
    batches = host_iter(epoch)
    aug_events = []

    def one(trace_aug=False):
        host = next(batches)
        if trace_aug:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            batch = augment(host, gen)
            b.record()
            aug_events.append((a, b))
        else:
            batch = augment(host, gen)
        return step(batch, epoch)

    judged = int(wl["judged_steps"])
    beta1 = optimizer.param_groups[0]["betas"][0]  # the configurations train with AdamW
    losses, grad1 = [], None
    for i in range(judged):
        losses.append(one()["loss"])
        if i == 0:
            grad1 = {n: (optimizer.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone()
                     if "exp_avg" in optimizer.state[p] else torch.zeros_like(p)
                     for n, p in model.named_parameters()}
    params_after = {n: p.detach().clone() for n, p in model.named_parameters()}
    ctx.mark(f"{judged} judged steps done")
    losses = [float(v) for v in losses]
    for _ in range(int(wl["warmup"])):
        one()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up steps done")
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    starts = []
    with Trace(ctx.trace) as tr:
        t0 = time.perf_counter()
        n = 0
        while True:
            if dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
            one(trace_aug=ctx.trace and dev.type == "cuda")
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        if dev.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    intervals = ([a.elapsed_time(b) for a, b in zip(starts, starts[1:] + [end])]
                 if dev.type == "cuda" else [])
    augment_ms = [a.elapsed_time(b) for a, b in aug_events]
    window_peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    del model, optimizer, step, augment
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx.mark(f"window closed: {n} steps")
    checks = judge(ctx, records, cfg, seed, epoch, params0, judged,
                   {"losses": losses, "grad1": grad1, "params": params_after})
    ctx.mark("reference done")
    limits = wl["limits"]
    compared = report([(k, v, limits[k]) for k, v in checks.items() if k in limits])
    ctx.mark(f"not compared (no limit in the cell): "
             f"{ {k: v for k, v in checks.items() if k not in limits} }")
    raw = {"setup_s": setup_s, "window_s": window_s, "steps": n, "intervals_ms": intervals,
           "augment_ms": augment_ms, "peak_reserved_window": window_peak,
           "trace": tr.summary, "model": cfg["MODEL"], "unit": "train_step",
           "crop": [A["CROP_WIDTH"], A["CROP_HEIGHT"], A["CROP_DEPTH"]],
           "batch": int(mix["batch"])}
    return {"correct": all(checks[k] <= v for k, v in limits.items()), "readings": checks,
            "attempted": n, "failed": 0, "raw": raw, "compared": compared,
            "memory_peak_bytes": max(setup_peak, window_peak)}


def judge(ctx, records, cfg, seed, epoch, params0, steps, prog):
    """The reference's verdict on the judged steps; with ``ctx.control``
    the fp8 reference stands in the program's place."""
    from benchmark.reference import quant
    from benchmark.reference import train as ref_train

    ref = ref_train.replay(records, cfg, seed, epoch, params0, steps, ctx.device)
    if getattr(ctx, "control", False):
        prog = ref_train.replay(records, cfg, seed, epoch, params0, steps, ctx.device,
                                q=quant.fp8)
    keep = ref_train.moved_leaves(ref["grad1"])
    delta_p = {k: prog["params"][k] - params0[k] for k in keep}
    delta_r = {k: ref["params"][k] - params0[k] for k in keep}
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    grads = ref_train.leaf_gaps(prog["grad1"], ref["grad1"], keep)
    moves = ref_train.leaf_gaps(delta_p, delta_r, keep)
    grad_d = ref_train.leaf_diffs(prog["grad1"], ref["grad1"], keep)
    move_d = ref_train.leaf_diffs(delta_p, delta_r, keep)
    for what, g in (("grad", grads), ("update", moves), ("grad diff", grad_d),
                    ("update diff", move_d)):
        worst = sorted(g, key=g.get)[-3:]
        ctx.mark(f"{what} gaps, worst leaves: "
                 + ", ".join(f"{k} {g[k]:.4g}" for k in reversed(worst)))
    ctx.mark(f"loss gaps by step (not compared) {gaps}; {len(keep)} of "
             f"{len(ref['grad1'])} leaves kept")
    return {"grad_gap": max(grads.values()), "update_gap": max(moves.values()),
            "grad_diff": max(grad_d.values()), "update_diff": max(move_d.values())}
