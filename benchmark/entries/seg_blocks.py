"""Segmentation of whole blocks on the card, one block at a time.

The unit is what ``run_inference``'s device branch does to a block
(``infer/engine.py::_run_device_engine``): the chunked pipeline
(``make_chunked_pipeline``) built once in set-up at the workload's knobs,
then ``run(volume, mean, std)`` on a host uint8 block and ``.cpu()`` of the
instance mask. The mix's distinct blocks are cycled in a closed loop.

Set-up: the model from the configuration's ``.skoots`` file, the blocks from
the seed, the pipeline, ``warmup`` blocks. The window runs whole blocks until
``--seconds`` have passed; the device's reserved peak is reset before it.

Correctness, on one block of the mix drawn from the seed: once the window
has closed and its peak has been read, the same pipeline object runs that
block once more with the capture armed (no capture runs inside the window).
It copies the model output of ``sample_tiles`` of its tiles, drawn from the
seed, as the pipeline produced them (a forward hook copies them to the
host); the CC's input mask and labels as the pipeline produced them (the
pipeline's CC factory is wrapped to copy them); the block's instance mask.
Then, with the program freed, the reference (``reference/seg.py``) segments
the block in f32 and judges:

* ``fwd_gap``: the largest |program - reference| over the five output
  channels of the sampled tiles;
* ``cc_mismatch``: voxels where the program's component labels of its own
  skeleton mask differ from that mask's 26-connected components (exact);
* ``fg_mismatch``: the share of the foreground voxels (of either instance
  mask) that only one of the program's and the reference's masks calls
  foreground;
* ``iou_miss_median`` and ``iou_miss_p90``: the median and the 90th
  percentile over the reference's instances of 1 - the IoU with the
  program instance that overlaps it most (the percentile sees a fault that
  mislabels a tenth of the instances or more).

The share of foreground voxels that the program's mask splits off or merges
away against the reference's (``inst_mismatch``) is printed, not compared:
one instance merged across a skeleton bridge that rounding opens or closes
moves it by a whole tube's voxels (PERF.md, section 2).
"""

from __future__ import annotations

import time

import numpy as np


class _Capture:
    """Copies of what the timed path produced on the sampled block."""

    def __init__(self):
        self.tiles = set()
        self.armed = False
        self.calls = 0
        self.out = {}
        self.cc_in = None
        self.cc_out = None

    def hook(self, module, inputs, output):
        if self.armed and self.calls in self.tiles:
            self.out[self.calls] = output[0].detach().cpu()
        self.calls += 1

    def arm(self, on: bool):
        self.armed = on
        self.calls = 0

    def wrap_cc(self, factory, fault=None):
        cap = self

        def make(*a, **k):
            inner = factory(*a, **k)

            class CC:
                def __call__(self, fg, **kw):
                    labels = inner(fg, **kw)
                    if fault == "cc":
                        labels = _split_largest(labels)
                    if cap.armed:
                        cap.cc_in = fg.cpu().numpy()
                        cap.cc_out = labels.cpu().numpy()
                    return labels

                def __getattr__(self, name):
                    return getattr(inner, name)

            return CC()

        return make


def _split_largest(labels):
    """A fault: the largest component's voxels below its median X plane
    given a label of their own."""
    import torch

    u, c = torch.unique(labels[labels > 0], return_counts=True)
    if len(u) == 0:
        return labels
    big = u[torch.argmax(c)]
    xs = torch.nonzero(labels == big)[:, 0]
    cut = torch.median(xs)
    x = torch.arange(labels.shape[0], device=labels.device).view(-1, 1, 1)
    fresh = labels.max() + 1
    return torch.where((labels == big) & (x < cut), fresh, labels)


def _alter(mask):
    """A fault: every instance of the block's mask split in two at its
    median X plane."""
    out = mask.copy()
    fresh = int(mask.max()) + 1
    for i, lab in enumerate(np.unique(mask[mask > 0])):
        xs = np.nonzero(mask == lab)[0]
        half = (mask == lab) & (np.arange(mask.shape[0])[:, None, None] < np.median(xs))
        out[half] = fresh + i
    return out


def run(ctx):
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer import device_pipeline as dp
    from skoots_tpu_torch.models import model_from_checkpoint

    from benchmark.harness import Trace

    dev = ctx.device
    wl = ctx.workload
    knobs = dict(wl["pipeline"])
    fault = getattr(ctx, "fault", None)
    weights = str(ctx.root / ctx.config["weights"])
    ckpt = load_checkpoint(weights)
    model = model_from_checkpoint(ckpt, device=dev)
    ctx.mark("model loaded")
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    knobs["vector_scale"] = [float(v) for v in ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]]
    blocks = ctx.generator.make(ctx.mix, ctx.seed, dev)
    shape = tuple(blocks[0]["volume"].shape)
    ctx.mark(f"{len(blocks)} blocks made ({[b['n_tubes'] for b in blocks]} tubes)")
    vox = int(np.prod(shape))

    rng = np.random.default_rng([ctx.seed & 0xFFFFFFFFFFFFFFFF, 17])
    sample_block = int(rng.integers(len(blocks)))
    cap = _Capture()
    factory = dp.make_label_components_stepped
    dp.make_label_components_stepped = cap.wrap_cc(factory, fault)
    try:
        run_block = dp.make_chunked_pipeline(
            model, shape, crop=tuple(knobs["crop"]), overlap=(0, 0, 0), assign_crop=None,
            vector_scale=tuple(knobs["vector_scale"]),
            prob_threshold=float(knobs["prob_threshold"]),
            semantic_threshold=float(knobs["semantic_threshold"]),
            embed_iterations=int(knobs["embed_iterations"]), embed_decay=1.0,
            embed_compact_div=int(knobs["compact_div"]),
            dilation_3d=int(knobs["dilation_3d"]), dilation_2d=int(knobs["dilation_2d"]),
            device=dev)
    finally:
        dp.make_label_components_stepped = factory
    n_tiles = run_block.tile_plan["forward"]
    picks = rng.choice(n_tiles, min(n_tiles, int(wl["sample_tiles"])), replace=False)
    cap.tiles = {int(t) for t in picks}

    def one(i):
        """Block ``i`` of the mix through the pipeline; its host mask and
        the seconds of ``run()`` and of the mask's copy."""
        t0 = time.perf_counter()
        out = run_block(blocks[i % len(blocks)]["volume"], mean, std)
        t1 = time.perf_counter()
        mask = out.cpu()
        t2 = time.perf_counter()
        if fault == "answer":
            mask = torch.from_numpy(_alter(mask.numpy()))
        return mask, t1 - t0, t2 - t1

    for i in range(int(wl["warmup"])):
        run_block(blocks[i % len(blocks)]["volume"], mean, std).cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.mark("warm-up blocks done")
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    phases, rounds, run_s, copy_s = [], [], [], []
    with Trace(ctx.trace) as tr:
        t0 = time.perf_counter()
        n = 0
        while True:
            _, r, c = one(n)
            run_s.append(r)
            copy_s.append(c)
            phases.append(dict(run_block.last_phase_s))
            rounds.append(run_block.last_cc_rounds)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0

    # the judged pass, after the window: the sampled block through the same
    # pipeline object with the capture armed
    hook = model.register_forward_hook(cap.hook)
    cap.arm(True)
    sampled_mask = one(sample_block)[0].numpy()
    cap.armed = False
    hook.remove()
    tiles_out, cc_in, cc_out = cap.out, cap.cc_in, cap.cc_out
    del run_block, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx.mark(f"window closed: {n} blocks; a block's run() median {np.median(run_s):.4f} s "
             f"(min {min(run_s):.4f}, max {max(run_s):.4f}), its mask's .cpu() median "
             f"{np.median(copy_s):.4f} s (min {min(copy_s):.4f}, max {max(copy_s):.4f}); "
             f"phases' medians {({k: float(np.median([p[k] for p in phases])) for k in phases[0]})}")
    checks = judge(ctx, weights, blocks[sample_block]["volume"], mean, std, knobs,
                   tiles_out, cc_in, cc_out, sampled_mask)
    ctx.mark("reference done")
    from benchmark.harness import report

    limits = wl["limits"]
    compared = report([(k, v, limits[k]) for k, v in checks.items() if k in limits])
    ctx.mark(f"not compared (no limit in the cell): "
             f"{ {k: v for k, v in checks.items() if k not in limits} }")
    raw = {"setup_s": setup_s, "window_s": window_s, "blocks": n, "voxels_per_block": vox,
           "peak_reserved_window": window_peak, "phases": phases, "cc_rounds": rounds,
           "run_s": run_s, "copy_s": copy_s,
           "trace": tr.summary, "model": ctx.config["cfg"]["MODEL"], "unit": "seg_block",
           "tile": list(knobs["crop"]), "tiles_per_block": n_tiles}
    return {"correct": all(checks[k] <= v for k, v in limits.items()), "readings": checks,
            "attempted": n, "failed": 0, "raw": raw, "compared": compared,
            "memory_peak_bytes": max(setup_peak, window_peak)}


def judge(ctx, weights, volume, mean, std, knobs, tiles_out, cc_in, cc_out, mask):
    """The reference's verdict on the sampled block (the numbers of the
    module's docstring); with ``ctx.control`` the fp8 reference stands in
    the program's place."""
    import torch

    from benchmark.reference import ckpt as ref_ckpt
    from benchmark.reference import model as ref_model
    from benchmark.reference import quant
    from benchmark.reference import seg as ref_seg

    ref_model.no_tf32()
    dev = ctx.device
    params = {k: v.to(dev) for k, v in ref_ckpt.state_dict(weights).items()}
    mcfg = ctx.config["cfg"]["MODEL"]
    ref_mask, ref_tiles = ref_seg.segment(params, mcfg, volume, mean, std, knobs, dev,
                                          keep_tiles=set(tiles_out))
    if getattr(ctx, "control", False):
        mask, tiles_out = ref_seg.segment(params, mcfg, volume, mean, std, knobs, dev,
                                          q=quant.fp8, keep_tiles=set(tiles_out))
        cc_mis = 0
    else:
        cc_mis = ref_seg.cc_mismatch(cc_in, cc_out)
    gap = max(float((tiles_out[i] - ref_tiles[i]).abs().max()) for i in ref_tiles)
    inst = ref_seg.partition_mismatch(torch.from_numpy(mask), torch.from_numpy(ref_mask))
    ctx.mark(f"instances (not compared): inst_mismatch {inst:.6g}, unmatched at IoU 0.5 "
             f"(reference, program, largest sizes) {ref_seg.unmatched(mask, ref_mask)}, "
             f"reference instances {len(np.unique(ref_mask)) - 1}")
    return {"fwd_gap": gap, "cc_mismatch": cc_mis,
            "fg_mismatch": ref_seg.fg_mismatch(mask, ref_mask),
            "iou_miss_median": ref_seg.iou_miss(mask, ref_mask, 0.5),
            "iou_miss_p90": ref_seg.iou_miss(mask, ref_mask, 0.9)}
