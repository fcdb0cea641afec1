"""Convergence proof: train on synthetic tubes, segment a held-out volume,
score its instances (port of ``tools/convergence.py``, names and result
keys kept).

    python -m skoots_tpu_torch.tools.convergence [--epochs 120]
        [--steps-per-epoch 8] [--outdir runs/convergence_torch] [--device cuda]

Renders three training phantoms (``make_tubes`` 128x128x32, 5 tubes of
radius 5, at least 16 voxels apart, seeds 100-102) and a validation one
(seed 999) under ``<outdir>/train`` and ``<outdir>/val``, writes the
training cfg (the 16-32-64 UNeXT, crop 96x96x32, one polarity) with the
port's own YAML writer, trains through ``skoots-train-torch``
(``train.cli.main``), segments the validation volume through
``infer.engine.run_inference`` (crop and assign crop 128x128x32, no
overlap, N = 10) and scores it with ``validate.metrics``.

Passes (exit code 0) when F1 at IoU 0.5 >= 0.8 and the mean best IoU of
the GT instances >= 0.7. ``<outdir>/result.json`` holds the JAX tool's keys
(``checkpoint`` relative to ``--outdir``) plus the engine that segmented,
the optimizer steps, the device and, on a card, its name and power limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def build_dataset(root: str, n_train: int = 3) -> tuple[str, str]:
    """``n_train`` training phantoms (seeds 100, 101, ...: ``vol<i>.tif``,
    ``.labels.tif``, ``.skeletons.npz``) under ``root/train`` and the
    validation phantom (seed 999) under ``root/val``; returns both dirs.
    ``min_separation``: skeleton-guided segmentation merges instances that
    interpenetrate, and organelles do not."""
    from skoots_tpu_torch.train.generate_skeletons import save_skeletons
    from skoots_tpu_torch.utils.io import imsave
    from skoots_tpu_torch.utils.synthetic import make_tubes

    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    for i in range(n_train):
        img, labels, skels = make_tubes(shape=(128, 128, 32), n_tubes=5, radius=5,
                                        seed=100 + i, min_separation=16.0)
        imsave(os.path.join(train_dir, f"vol{i}.tif"), img)
        imsave(os.path.join(train_dir, f"vol{i}.labels.tif"), labels)
        save_skeletons(os.path.join(train_dir, f"vol{i}.skeletons.npz"), skels)
    img, labels, _ = make_tubes(shape=(128, 128, 32), n_tubes=5, radius=5, seed=999,
                                min_separation=16.0)
    imsave(os.path.join(val_dir, "val.tif"), img)
    imsave(os.path.join(val_dir, "val.labels.tif"), labels)
    return train_dir, val_dir


def write_cfg(path: str, train_dir: str, save_dir: str, epochs: int) -> None:
    """The proof's training cfg, the JAX tool's key for key: the accuracy
    campaign's ``separated`` cfg (``accuracy_campaign.write_cfg``)."""
    from skoots_tpu_torch.tools.accuracy_campaign import write_cfg as campaign_cfg

    campaign_cfg(path, train_dir, save_dir, epochs, "separated")


def main(argv=None) -> int:
    from skoots_tpu_torch.tools.accuracy_campaign import _device_record, _relative
    from skoots_tpu_torch.tools.score_checkpoint import segment_and_score
    from skoots_tpu_torch.train.cli import main as train_main
    from skoots_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.convergence",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--steps-per-epoch", type=int, default=8)
    ap.add_argument("--outdir", default="runs/convergence_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and segment on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    root = os.path.abspath(args.outdir)
    save_dir = os.path.join(root, "models")
    os.makedirs(save_dir, exist_ok=True)
    train_dir, val_dir = build_dataset(root)
    cfg_path = os.path.join(root, "cfg.yaml")
    write_cfg(cfg_path, train_dir, save_dir, args.epochs)

    t0 = time.time()
    rc = train_main(["--config-file", cfg_path, "--steps-per-epoch", str(args.steps_per_epoch),
                     "--log", "2", "--device", str(device)])
    train_s = time.time() - t0
    if rc != 0:
        print(json.dumps({"ok": False, "stage": "train", "rc": rc}))
        return 1
    ckpts = sorted(glob.glob(os.path.join(save_dir, "*.skoots")))
    if not ckpts:
        raise RuntimeError("training wrote no checkpoint")

    scored = segment_and_score(val_dir, ckpts[-1], device)
    result = {**scored, "train_s": round(train_s, 1), "epochs": args.epochs,
              "steps": args.epochs * args.steps_per_epoch,
              "checkpoint": _relative(ckpts[-1], root), **_device_record(device)}
    print(json.dumps(result))
    with open(os.path.join(root, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
