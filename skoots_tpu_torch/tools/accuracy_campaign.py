"""Accuracy campaign: train and score the port's whole pipeline on six
phantom scenarios (port of ``tools/accuracy_campaign.py``, names kept).

    python -m skoots_tpu_torch.tools.accuracy_campaign [--scenario NAME]
        [--epochs 150] [--steps-per-epoch 10] [--device cuda]
        [--outdir runs/accuracy_torch] [--rescore] [--manual-knobs]

Scenarios (each renders its phantoms from seeds, trains its own checkpoint
with ``skoots-train-torch`` and segments a held-out phantom with
``infer.engine.run_inference``):

  separated  5 well-separated tubes
  touching   tubes whose surfaces touch (centrelines stay apart)
  aniso      a 192x192x32 stack with 20+ thin tubes
  blobs      compact blobs (the degenerate-skeleton regime)
  sparse     weakly supervised training (skeletons and certain background
             only, ``EXPERIMENTAL.IS_SPARSE``) on the separated phantom
  perslice   the per-slice 2D mode (``infer/perslice.py``) on the aniso
             checkpoint and validation volume

Bars (F1 at IoU 0.5, the JAX campaign's): the dense scenarios 0.8, sparse
0.7, perslice 0.6. Each scenario writes ``<outdir>/<scenario>/result.json``
(the JAX tool's keys, plus the device, the card's name and power limit and
the optimizer steps trained; ``checkpoint`` is relative to ``--outdir``, and
``diag_semantic``, which JAX's tool writes on a miss only, is written for
every scenario but perslice); the summary of all results on disk goes to
``<outdir>/campaign.json``. Runs on ``--device`` (default ``cuda``); the cfg
is written by the port's own YAML writer (``config.dump_yaml``), so neither
PyYAML nor JAX is needed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

SCENARIOS = ("separated", "touching", "aniso", "blobs", "sparse", "perslice")

BARS = {"separated": 0.8, "touching": 0.8, "aniso": 0.8, "blobs": 0.8,
        "sparse": 0.7, "perslice": 0.6}

# the hand-derived per-scenario dilation stacks; by default the campaign
# passes no knobs and the engine's auto mode (infer/autoknobs.py) derives
# them from the skeleton spacing it measures; --manual-knobs restores these
MANUAL_KNOBS = {
    "touching": {"dilation_3d": 0, "dilation_2d": 1},
    "aniso": {"dilation_3d": 0, "dilation_2d": 1},
    # blobs sit ~4 voxels apart: the default 2x2D dilation bridges one
    # skeleton pair; (1, 1) keeps them apart
    "blobs": {"dilation_3d": 1, "dilation_2d": 1},
}
INFER_KNOBS: dict = {}  # set in main(): {} (auto) or MANUAL_KNOBS


def _phantom(scenario: str, seed: int):
    """The scenario's phantom with the EM-realism stack (texture,
    illumination gradient, membrane distractors, anisotropic PSF:
    ``utils.synthetic.apply_em_realism``) applied to the image only; the
    labels and skeletons stay exact. ``CAMPAIGN_REALISM=0`` keeps the clean
    generator's image."""
    img, labels, skels = _phantom_clean(scenario, seed)
    if os.environ.get("CAMPAIGN_REALISM", "1") != "0":
        from skoots_tpu_torch.utils.synthetic import apply_em_realism

        img = apply_em_realism(img, labels, seed=seed + 7)
    return img, labels, skels


def _phantom_clean(scenario: str, seed: int):
    from skoots_tpu_torch.utils.synthetic import make_blobs, make_tubes

    if scenario == "separated":
        return make_tubes(shape=(128, 128, 32), n_tubes=5, radius=5,
                          seed=seed, min_separation=16.0)
    if scenario == "sparse":
        # depth 96, three times the crop's, so random z offsets hide the
        # absolute z of the ablated background slices from the network
        return make_tubes(shape=(128, 128, 96), n_tubes=5, radius=5,
                          seed=seed, min_separation=16.0)
    if scenario == "touching":
        # radius 5: surfaces touch at a centreline distance of about 10-11
        return make_tubes(shape=(128, 128, 32), n_tubes=6, radius=5,
                          seed=seed, min_separation=11.0)
    if scenario in ("aniso", "perslice"):
        return make_tubes(shape=(192, 192, 32), n_tubes=24, radius=4,
                          seed=seed, min_separation=10.0)
    if scenario == "blobs":
        return make_blobs(shape=(128, 128, 32), n_blobs=20, seed=seed,
                          min_separation=4.0)
    raise ValueError(scenario)


def build_dataset(root: str, scenario: str, n_train: int = 3):
    """``n_train`` training phantoms (seeds 100, 101, ...) under
    ``root/train`` and the validation phantom (seed 999) under
    ``root/val``. Dense scenarios write ``<name>.tif``, ``.labels.tif`` and
    ``.skeletons.npz``; sparse writes weak annotations instead of labels:
    the certain background (exact where given; the cfg ablates it to 75% of
    the z-slices) and the skeleton stamp."""
    from skoots_tpu_torch.ops.skeleton import pack_skeletons, skeleton_to_mask
    from skoots_tpu_torch.train.generate_skeletons import save_skeletons
    from skoots_tpu_torch.utils.io import imsave

    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    for i in range(n_train):
        img, labels, skels = _phantom(scenario, seed=100 + i)
        base = os.path.join(train_dir, f"vol{i}")
        imsave(base + ".tif", img)
        if scenario == "sparse":
            imsave(base + ".background.tif", (labels == 0).astype(np.uint8))
            sk_mask = skeleton_to_mask(pack_skeletons(skels), labels.shape, radius=3,
                                       flank_radius=1).numpy()
            imsave(base + ".skeleton_mask.tif", sk_mask.astype(np.uint8))
        else:
            imsave(base + ".labels.tif", labels)
        save_skeletons(base + ".skeletons.npz", skels)
    img, labels, _ = _phantom(scenario, seed=999)
    imsave(os.path.join(val_dir, "val.tif"), img)
    imsave(os.path.join(val_dir, "val.labels.tif"), labels)
    return train_dir, val_dir


def write_cfg(path: str, train_dir: str, save_dir: str, epochs: int,
              scenario: str) -> dict:
    """The scenario's training cfg (the JAX campaign's, key for key),
    written to ``path`` by ``config.dump_yaml``; returns the dict."""
    from skoots_tpu_torch.config import dump_yaml

    cfg = {
        "MODEL": {
            "DIMS": [16, 32, 64, 32, 16],
            "DEPTHS": [1, 1, 1, 1, 1],
            "KERNEL_SIZE": 7,
            "OUT_CHANNELS": 16,
        },
        "TRAIN": {
            "TRAIN_DATA_DIR": [train_dir],
            "TRAIN_SAMPLE_PER_IMAGE": [8],
            "TRAIN_STORE_DATA_ON_GPU": [True],
            "NUM_EPOCHS": epochs,
            "LEARNING_RATE": 1e-3,
            "SAVE_INTERVAL": max(epochs // 2, 1),
            "SAVE_PATH": save_dir,
            "MAX_SKELETON_POINTS": 256,
            "VALIDATE_EPOCH_SKIP": epochs + 1,
            "LOSS_SKELETON_START_EPOCH": -1,
            "INITIAL_SIGMA": [8.0, 8.0, 4.0],
            "SIGMA_DECAY": [
                [0.66, int(epochs * 0.3)],
                [0.66, int(epochs * 0.6)],
                [0.5, int(epochs * 0.85)],
            ],
            "SKELETON_MASK_RADIUS": 3,
            "SCHEDULER_T0": epochs + 1,
        },
        "AUGMENTATION": {
            "CROP_WIDTH": 96,
            "CROP_HEIGHT": 96,
            "CROP_DEPTH": 32,
            "INVERT_RATE": 0.0,  # one polarity
        },
        "SKOOTS": {"VECTOR_SCALING": [12, 12, 6]},
    }
    if scenario == "sparse":
        # DIST_THR at the tube radius; certain background on 75% of the
        # z-slices; the sigma decay front-loaded, so the SWA epochs all run
        # at the final sigma (the semantic target is embed_prob > 0.2, whose
        # radius sigma sets); isotropic bake (the phantom is isotropic)
        cfg["EXPERIMENTAL"] = {
            "IS_SPARSE": True,
            "DIST_THR": 5.0,
            "BACKGROUND_SLICE_PERCENTAGE": 0.75,
        }
        cfg["TRAIN"]["SIGMA_DECAY"] = [
            [0.66, int(epochs * 0.15)],
            [0.66, int(epochs * 0.30)],
            [0.5, int(epochs * 0.45)],
        ]
        cfg["AUGMENTATION"]["BAKE_SKELETON_ANISOTROPY"] = [1.0, 1.0, 1.0]
        cfg["TRAIN"]["LEARNING_RATE"] = 5e-4
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return cfg


def score(gt: np.ndarray, pred: np.ndarray, device="cpu") -> dict:
    """F1 at IoU 0.5, the mean best IoU of the GT instances and the counts,
    from ``validate.metrics`` on ``device``: ``score_checkpoint.score``
    without its ``ok`` (each scenario has its own bar)."""
    from skoots_tpu_torch.tools.score_checkpoint import score as scored

    result = scored(gt, pred, device)
    del result["ok"]
    return result


def _device_record(device) -> dict:
    """The device a result was measured on: its name and, for a card, the
    power limit (``nvidia-smi``; None where it cannot be read)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": str(dev), "name": "cpu", "power_limit": None}
    name, limit = torch.cuda.get_device_name(dev), None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        limit = out[dev.index or 0].split(",")[-1].strip() if out else None
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"device": str(dev), "name": name, "power_limit": limit}


def _relative(ckpt: str, outdir: str) -> str:
    """A checkpoint's path as a result records it: relative to ``outdir``,
    so the results stay valid in another checkout or a moved outdir."""
    return os.path.relpath(os.path.abspath(ckpt), os.path.abspath(outdir))


def _resolve(ckpt: str | None, outdir: str) -> str | None:
    """A recorded checkpoint path, resolved against ``outdir``."""
    return os.path.join(outdir, ckpt) if ckpt else None


def _diag_semantic(root: str) -> dict:
    """Semantic precision and recall against the GT foreground from the
    persisted phase-1 buffer: tells a fat or thin mask from merged or split
    instances."""
    from skoots_tpu_torch.utils.io import imread

    try:
        stem = os.path.splitext(os.path.join(root, "val", "val.tif"))[0]
        sem = np.load(stem + "_skoots_semantic.npy", mmap_mode="r")
        gt_fg = np.asarray(imread(os.path.join(root, "val", "val.labels.tif"))).squeeze() > 0
        pred_fg = np.asarray(sem).squeeze() > 0.5
        tp_v = float((pred_fg & gt_fg).sum())
        return {
            "precision": round(tp_v / max(pred_fg.sum(), 1), 4),
            "recall": round(tp_v / max(gt_fg.sum(), 1), 4),
            "pred_fg_frac": round(float(pred_fg.mean()), 4),
            "gt_fg_frac": round(float(gt_fg.mean()), 4),
        }
    except (OSError, ValueError) as e:  # a diagnosis never fails the scenario
        return {"error": repr(e)}


def run_scenario(scenario: str, outdir: str, epochs: int, steps_per_epoch: int,
                 aniso_ckpt: str | None = None, rescore: bool = False,
                 device="cuda") -> dict:
    """Build, train, segment and score one scenario on ``device``; writes
    and returns its result (``perslice`` scores the aniso checkpoint)."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer.engine import run_inference
    from skoots_tpu_torch.utils.io import imread

    root = os.path.abspath(os.path.join(outdir, scenario))
    save_dir = os.path.join(root, "models")
    os.makedirs(save_dir, exist_ok=True)

    t_start = time.time()
    steps = 0
    if scenario == "perslice":
        if not aniso_ckpt:
            raise ValueError("perslice needs the aniso scenario's checkpoint")
        from skoots_tpu_torch.infer.perslice import perslice_segment

        _, val_dir = build_dataset(root, scenario, n_train=0)
        val_img = os.path.join(val_dir, "val.tif")
        # phase 1 once through the engine (it stores the vectors, skeleton
        # and semantic buffers), with the aniso scenario's dilation regime
        run_inference(val_img, aniso_ckpt, crop_size=(192, 192, 32),
                      overlap=(0, 0, 0), assign_crop_size=(192, 192, 32),
                      assign_overlap=(0, 0, 0), embed_iterations=1, device=device,
                      **INFER_KNOBS.get("aniso", {}))
        stem = os.path.splitext(val_img)[0]
        vectors = np.load(stem + "_skoots_vectors.npy", mmap_mode="r")
        skeleton = np.load(stem + "_skoots_skeleton.npy", mmap_mode="r")
        semantic = np.load(stem + "_skoots_semantic.npy", mmap_mode="r")
        scale = tuple(load_checkpoint(aniso_ckpt)["cfg"]["SKOOTS"]["VECTOR_SCALING"])
        pred = perslice_segment(vectors, skeleton, semantic, scale, embed_iterations=10,
                                device=device)
        gt = np.asarray(imread(os.path.join(val_dir, "val.labels.tif"))).squeeze()
        result = {"scenario": scenario, **score(gt, np.asarray(pred).squeeze(), device),
                  "checkpoint": _relative(aniso_ckpt, outdir)}
    else:
        ckpts = sorted(glob.glob(os.path.join(save_dir, "*.skoots")))
        if rescore and ckpts:
            val_dir = os.path.join(root, "val")
            ckpt = ckpts[-1]
        else:
            train_dir, val_dir = build_dataset(root, scenario)
            cfg_path = os.path.join(root, "cfg.yaml")
            write_cfg(cfg_path, train_dir, save_dir, epochs, scenario)

            from skoots_tpu_torch.train.cli import main as train_main

            rc = train_main(["--config-file", cfg_path,
                             "--steps-per-epoch", str(steps_per_epoch),
                             "--log", "2", "--device", str(device)])
            if rc != 0:
                return {"scenario": scenario, "ok": False, "stage": "train", "rc": rc}
            ckpts = sorted(glob.glob(os.path.join(save_dir, "*.skoots")))
            if not ckpts:
                raise RuntimeError(f"{scenario}: training wrote no checkpoint")
            ckpt = ckpts[-1]
            steps = epochs * steps_per_epoch

        val_img = os.path.join(val_dir, "val.tif")
        shape = imread(val_img).shape
        # the cached phase-1 buffers hold the skeleton map after dilation,
        # so a scenario with dilation knobs runs the forward again
        mask = run_inference(
            val_img, ckpt,
            use_cached_data=rescore and scenario not in INFER_KNOBS and bool(
                glob.glob(os.path.splitext(val_img)[0] + "_skoots_vectors.npy")),
            crop_size=(*shape[:2], 32), overlap=(0, 0, 0),
            assign_crop_size=(*shape[:2], 32), assign_overlap=(0, 0, 0),
            embed_iterations=10, device=device,
            **INFER_KNOBS.get(scenario, {}),
        )
        gt = np.asarray(imread(os.path.join(val_dir, "val.labels.tif"))).squeeze()
        result = {"scenario": scenario, **score(gt, np.asarray(mask).squeeze(), device),
                  "checkpoint": _relative(ckpt, outdir),
                  "diag_semantic": _diag_semantic(root)}

    result["ok"] = bool(result.get("f1_at_iou50", 0) >= BARS[scenario])
    result["bar"] = BARS[scenario]
    result["wall_s"] = round(time.time() - t_start, 1)
    result["steps"] = steps
    result.update(_device_record(device))
    with open(os.path.join(root, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.accuracy_campaign",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenario", choices=SCENARIOS + ("all",), default="all")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--outdir", default="runs/accuracy_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and segment on (default cuda)")
    ap.add_argument("--rescore", action="store_true",
                    help="reuse an existing trained checkpoint (and cached phase-1 "
                         "buffers) and only run the segmentation and scoring again")
    ap.add_argument("--manual-knobs", action="store_true",
                    help="use the hand-derived per-scenario dilation stacks instead "
                         "of the engine's auto mode")
    args = ap.parse_args(argv)

    if args.manual_knobs:
        INFER_KNOBS.update(MANUAL_KNOBS)

    todo = list(SCENARIOS) if args.scenario == "all" else [args.scenario]
    aniso_ckpt = None
    for s in todo:
        if s == "perslice" and aniso_ckpt is None:
            prior = os.path.join(args.outdir, "aniso", "result.json")
            if os.path.exists(prior):
                with open(prior) as f:
                    aniso_ckpt = _resolve(json.load(f).get("checkpoint"), args.outdir)
            if not aniso_ckpt:
                print("perslice: no aniso checkpoint available, skipping")
                continue
        r = run_scenario(s, args.outdir, args.epochs, args.steps_per_epoch, aniso_ckpt,
                         rescore=args.rescore, device=args.device)
        if s == "aniso" and r.get("checkpoint"):
            aniso_ckpt = _resolve(r["checkpoint"], args.outdir)

    # the summary is made from the results on disk, so partial and rescore
    # runs fold into earlier ones
    results = []
    for s in SCENARIOS:
        p = os.path.join(args.outdir, s, "result.json")
        if os.path.exists(p):
            with open(p) as f:
                results.append(json.load(f))
    summary = {"ok": all(r.get("ok") for r in results) and bool(results),
               "results": results}
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "campaign.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"campaign_ok": summary["ok"],
                      "scenarios": {r["scenario"]: r.get("f1_at_iou50") for r in results}}))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
