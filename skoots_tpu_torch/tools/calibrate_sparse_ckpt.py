"""Retrofit the semantic-threshold calibration onto an existing sparse
checkpoint (port of ``tools/calibrate_sparse_ckpt.py``).

    python -m skoots_tpu_torch.tools.calibrate_sparse_ckpt CKPT TRAIN_DIR
        [--device cuda]

Sparse training calibrates its semantic threshold at save time
(``experimental.sparse_engine.make_threshold_calibrator``); a checkpoint
trained before that has none, and inference then gates at the default 0.8
(a mask several times too fat). This tool runs the same calibration with
the checkpoint's weights and dataset statistics on the sparse volumes of
``TRAIN_DIR`` (``<name>.tif``, ``.background.tif``, ``.skeletons.npz``) and
rewrites the checkpoint in place with ``extra.calibrated_prob_threshold``
set, so ``run_inference`` adopts it. Everything else -- the parameters bit
for bit, the optimizer state, the other ``extra`` keys, the cfg and the
dataset statistics -- is written back as it was read; both packages load
the file. Exits 1 when no calibration window holds a skeleton point.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def calibrate_checkpoint(ckpt_path: str, train_dir: str, device="cuda") -> Optional[float]:
    """Calibrate ``ckpt_path`` on ``train_dir`` on ``device`` and, unless
    the calibrator returns None, rewrite the checkpoint with the threshold.
    Returns the threshold (None when nothing was written)."""
    from skoots_tpu_torch.checkpoint import (load_checkpoint, save_checkpoint,
                                             torch_params_from_flax)
    from skoots_tpu_torch.experimental.data import SparseDataset
    from skoots_tpu_torch.experimental.sparse_engine import make_threshold_calibrator
    from skoots_tpu_torch.models import cfg_to_model
    from skoots_tpu_torch.train.checkpoint import restore_params
    from skoots_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    ck = load_checkpoint(ckpt_path)
    cfg = ck["cfg"]
    model = restore_params(cfg_to_model(cfg, device), ck["params"])
    dataset = SparseDataset(train_dir, cfg, sample_per_image=8)
    thr = make_threshold_calibrator(cfg, dataset, ck["dataset_mean"], ck["dataset_std"])(model)
    if thr is None:
        return None
    extra = dict(ck.get("extra") or {})
    extra["calibrated_prob_threshold"] = float(thr)
    # the parameters as read (not the model's copies): bit for bit
    save_checkpoint(ckpt_path, cfg, torch_params_from_flax(ck["params"]), ck.get("opt_state"),
                    dataset_mean=ck["dataset_mean"], dataset_std=ck["dataset_std"],
                    extra=extra)
    return float(thr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.calibrate_sparse_ckpt",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt")
    ap.add_argument("train_dir")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the calibration forwards on (default cuda)")
    args = ap.parse_args(argv)

    thr = calibrate_checkpoint(args.ckpt, args.train_dir, args.device)
    print(f"calibrated semantic threshold: {thr}")
    if thr is None:
        return 1
    print(f"updated {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
