"""``skoots-train-torch`` / ``python -m skoots_tpu_torch.train``: the
training CLI (port of ``skoots_tpu/train/cli.py``).

    python -m skoots_tpu_torch.train --config-file cfg.yaml [-b] \
        [--steps-per-epoch N] [--device cuda]

Loads and validates the YAML cfg (the JAX package's schema), builds the
datasets, augments every batch on ``--device`` and trains there. One device
only: a mesh (``SYSTEM.MESH_DATA`` other than -1 or 1, ``MESH_SPACE`` other
than 1) and sparse training raise ``NotImplementedError``. The device is
explicit (default ``cuda``); nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

import torch

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="skoots-train-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", type=str, help="YAML config (reference schema)")
    p.add_argument("-b", "--batch", action="store_true",
                   help="treat --config-file as a directory and run every *.yaml in it")
    p.add_argument("--log", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="override steps per epoch (default: dataset length / batch size)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda)")
    return p


def run_config(cfg_path: str, device: str, steps_per_epoch=None):
    from skoots_tpu_torch.config import load_cfg_from_file
    from skoots_tpu_torch.train.data import (
        MultiDataset,
        SkootsDataset,
        batch_iterator,
        prefetch_iterator,
    )
    from skoots_tpu_torch.train.engine import train
    from skoots_tpu_torch.train.transforms import make_batch_augment

    cfg = load_cfg_from_file(cfg_path)
    t = cfg["TRAIN"]
    if cfg["EXPERIMENTAL"]["IS_SPARSE"]:
        raise NotImplementedError("sparse training is not ported yet (see ROADMAP.md)")
    if cfg["SYSTEM"]["MESH_DATA"] not in (-1, 1) or cfg["SYSTEM"]["MESH_SPACE"] != 1:
        raise NotImplementedError(
            "the port trains on one device: SYSTEM.MESH_DATA must be -1 or 1 and "
            "SYSTEM.MESH_SPACE 1 (multi-GPU is queued in ROADMAP.md)")

    datasets = [SkootsDataset(d, cfg, sample_per_image=s)
                for d, s in zip(t["TRAIN_DATA_DIR"], t["TRAIN_SAMPLE_PER_IMAGE"])]
    for d, s in zip(t["BACKGROUND_DATA_DIR"], t["BACKGROUND_SAMPLE_PER_IMAGE"]):
        datasets.append(SkootsDataset(d, cfg, sample_per_image=s, background=True))
    dataset = MultiDataset(datasets)
    invert_rate = cfg["AUGMENTATION"].get("INVERT_RATE",
                                          cfg["AUGMENTATION"]["BRIGHTNESS_RATE"])
    mean, std = dataset.mean_std(with_invert=invert_rate > 0)
    ceiling = dataset.intensity_ceiling()
    radius = dataset.object_radius()
    log.info("dataset: %d samples/epoch, mean=%.3f std=%.3f ceil=%d object_radius=%s",
             len(dataset), mean, std, ceiling,
             "n/a" if radius is None else f"{radius:.1f}vox")

    bsz = t["TRAIN_BATCH_SIZE"]
    steps = steps_per_epoch or max(1, len(dataset) // bsz)
    host_iter = prefetch_iterator(batch_iterator(dataset, bsz, steps, t["SEED"]))
    augment = make_batch_augment(cfg, mean, std, intensity_ceiling=ceiling, device=device)

    def data_iter(epoch: int):
        gen = torch.Generator().manual_seed(t["SEED"] + epoch)
        for host_batch in host_iter(epoch):
            yield augment(host_batch, gen)

    val_data_iter = None
    val_sets = [SkootsDataset(d, cfg, sample_per_image=s)
                for d, s in zip(t["VALIDATION_DATA_DIR"], t["VALIDATION_SAMPLE_PER_IMAGE"])]
    if val_sets:
        val_multi = MultiDataset(val_sets)
        vb = t["VALIDATION_BATCH_SIZE"]
        val_host = batch_iterator(val_multi, vb, max(1, len(val_multi) // vb), t["SEED"] + 999)

        def val_data_iter(epoch: int):
            gen = torch.Generator().manual_seed(t["SEED"] + 31 * epoch)
            for host_batch in val_host(epoch):
                yield augment(host_batch, gen)

    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter()
    except ImportError:
        log.warning("tensorboard unavailable; scalar logging to the log only")

    return train(cfg, data_iter, device, val_data_iter, dataset_mean=mean,
                 dataset_std=std, writer=writer, object_radius=radius)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=[logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][min(args.log, 3)],
        format="[%(asctime)s] skoots-train-torch [%(levelname)s]: %(message)s",
    )
    if not args.config_file:
        print("usage: skoots-train-torch --config-file cfg.yaml [-b]", file=sys.stderr)
        return 2
    if args.batch:
        configs = sorted(glob.glob(os.path.join(args.config_file, "*.yaml")))
        if not configs:
            raise FileNotFoundError(f"no *.yaml under {args.config_file}")
    else:
        configs = [args.config_file]
    for c in configs:
        log.info("training with %s", c)
        run_config(c, args.device, steps_per_epoch=args.steps_per_epoch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
