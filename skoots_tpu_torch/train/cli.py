"""``skoots-train-torch`` / ``python -m skoots_tpu_torch.train``: the
training CLI (port of ``skoots_tpu/train/cli.py``).

    python -m skoots_tpu_torch.train --config-file cfg.yaml [-b] \
        [--steps-per-epoch N] [--device cuda]

Loads and validates the YAML cfg (the JAX package's schema), builds the
datasets, augments every batch on ``--device`` and trains there; a cfg with
``EXPERIMENTAL.IS_SPARSE`` trains sparse
(``experimental/sparse_engine.py::train_sparse``, on one device). Dense
training takes JAX's mesh (``SYSTEM.MESH_DATA``, ``MESH_SPACE``): the
data axis is ``MESH_DATA``, or for -1 the largest divisor of the batch
that the devices allow, and with more than one device the step runs
data-parallel over them from this process (``train/engine.py``).
``--device cuda`` means every visible card; a comma list names the
devices (``--device cpu,cpu``; they may repeat). The device is explicit
(default ``cuda``); nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import glob
import logging
import math
import os
import sys

import numpy as np
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
                   help="torch device to train on (default cuda: every visible "
                        "card for a mesh); a comma list names the mesh's devices")
    return p


def train_mesh(cfg: dict, devices: list):
    """JAX's mesh for dense training (``skoots_tpu/train/cli.py:91-123``):
    ``data = MESH_DATA``, or ``gcd(batch, n_devices // MESH_SPACE)`` for -1;
    a mesh over the first ``data * space`` devices when that is above 1,
    else None. Raises where the data axis does not divide the batch."""
    from skoots_tpu_torch.parallel import make_mesh

    bsz = cfg["TRAIN"]["TRAIN_BATCH_SIZE"]
    space = cfg["SYSTEM"]["MESH_SPACE"]
    if cfg["SYSTEM"]["MESH_DATA"] != -1:
        data_axis = cfg["SYSTEM"]["MESH_DATA"]
    else:
        # data axis must divide the global batch; use as many devices as fit
        data_axis = math.gcd(bsz, max(len(devices) // space, 1))
    if data_axis < 1 or bsz % data_axis:
        raise ValueError(f"SYSTEM.MESH_DATA {data_axis} does not divide "
                         f"TRAIN.TRAIN_BATCH_SIZE {bsz}")
    if data_axis * space <= 1:
        return None
    mesh = make_mesh(data=data_axis, space=space, devices=devices[:data_axis * space])
    log.info("mesh: %s over %d devices", dict(mesh.shape), data_axis * space)
    return mesh


def run_config(cfg_path: str, device, steps_per_epoch=None):
    from skoots_tpu_torch.config import load_cfg_from_file
    from skoots_tpu_torch.train.data import (
        MultiDataset,
        SkootsDataset,
        batch_iterator,
        prefetch_iterator,
    )
    from skoots_tpu_torch.train.engine import train
    from skoots_tpu_torch.train.transforms import make_batch_augment

    from skoots_tpu_torch.utils.device import resolve_devices

    cfg = load_cfg_from_file(cfg_path)
    t = cfg["TRAIN"]
    device, devices = resolve_devices(device)
    if cfg["EXPERIMENTAL"]["IS_SPARSE"]:
        from skoots_tpu_torch.experimental.sparse_engine import train_sparse

        return train_sparse(cfg, steps_per_epoch=steps_per_epoch, device=device)
    mesh = train_mesh(cfg, devices)

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

    writer = summary_writer()
    if writer is None:
        log.warning("tensorboard unavailable; scalar logging to the log only")

    return train(cfg, data_iter, device, val_data_iter, dataset_mean=mean,
                 dataset_std=std, writer=writer, object_radius=radius, mesh=mesh)


def summary_writer(log_dir=None):
    """TensorBoard's ``SummaryWriter`` (None without tensorboard), whose
    ``add_image`` encodes the image with ``train/viz.py::png_bytes``:
    torch's image summary imports Pillow, which the card's machine may
    lack. It takes what the training panels are, uint8 RGB ``[H, W, 3]``
    (``dataformats="HWC"``), and raises on anything else."""
    try:
        from tensorboard.compat.proto.summary_pb2 import Summary
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    from skoots_tpu_torch.train.viz import png_bytes

    class Writer(SummaryWriter):
        def add_image(self, tag, img_tensor, global_step=None, walltime=None,
                      dataformats="CHW"):
            img = np.asarray(img_tensor)
            if img.dtype != np.uint8 or dataformats != "HWC" or img.ndim != 3 \
                    or img.shape[-1] != 3:
                raise ValueError(f"add_image takes uint8 [H, W, 3] HWC, got {img.dtype} "
                                 f"{img.shape} {dataformats}")
            image = Summary.Image(height=img.shape[0], width=img.shape[1], colorspace=3,
                                  encoded_image_string=png_bytes(img))
            self._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, image=image)]), global_step, walltime)

    return Writer(log_dir)


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
