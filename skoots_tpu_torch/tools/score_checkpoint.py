"""Score a checkpoint on the convergence validation volume (port of
``tools/score_checkpoint.py``, keys kept).

    python -m skoots_tpu_torch.tools.score_checkpoint
        [--outdir runs/convergence_torch] [--ckpt CKPT] [--device cuda]

Segments ``<outdir>/val/val.tif`` with ``infer.engine.run_inference`` at
the convergence proof's knobs (crop and assign crop 128x128x32, no
overlap, N = 10) and scores it against ``<outdir>/val/val.labels.tif``
with ``validate.metrics``: F1 at IoU 0.5, the mean best IoU of the GT
instances and the counts; ``ok`` when F1 >= 0.8 and mean IoU >= 0.7.
``--ckpt`` defaults to the newest ``<outdir>/models/*.skoots``. Prints the
result and writes it to ``<outdir>/result.json``, with the engine that
ran, the device and, on a card, its name and power limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

F1_BAR, IOU_BAR = 0.8, 0.7
INFER_KNOBS = dict(crop_size=(128, 128, 32), overlap=(0, 0, 0),
                   assign_crop_size=(128, 128, 32), assign_overlap=(0, 0, 0),
                   embed_iterations=10)


def score(gt: np.ndarray, pred: np.ndarray, device="cpu") -> dict:
    """``ok`` (F1 >= 0.8 and mean IoU >= 0.7, before rounding), F1 at IoU
    0.5, the mean best IoU of the GT instances and the counts, from
    ``validate.metrics`` on ``device``."""
    import torch

    from skoots_tpu_torch.validate.metrics import accuracies_from_iou, mask_iou

    iou = mask_iou(gt, pred, device=device)
    n_gt, n_pred = iou.shape
    best = iou.max(dim=1).values if iou.numel() else torch.zeros(n_gt, dtype=torch.float64)
    tp, fp, fn = accuracies_from_iou(iou, 0.5)
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    mean_iou = float(best.mean()) if best.numel() else 0.0
    return {
        "ok": bool(f1 >= F1_BAR and mean_iou >= IOU_BAR),
        "f1_at_iou50": round(float(f1), 4),
        "mean_iou": round(mean_iou, 4),
        "tp": int(tp), "fp": int(fp), "fn": int(fn),
        "gt_instances": int(n_gt), "pred_instances": int(n_pred),
    }


def segment_and_score(val_dir: str, ckpt: str, device="cuda") -> dict:
    """Segment ``val_dir/val.tif`` with ``ckpt`` on ``device`` and score it
    (:func:`score`); adds ``infer_s`` and the ``engine`` that ran."""
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.utils.io import imread

    t0 = time.time()
    mask = engine.run_inference(os.path.join(val_dir, "val.tif"), ckpt, device=device,
                                **INFER_KNOBS)
    infer_s = time.time() - t0
    gt = np.asarray(imread(os.path.join(val_dir, "val.labels.tif"))).squeeze()
    return {**score(gt, np.asarray(mask).squeeze(), device),
            "infer_s": round(infer_s, 1), "engine": engine.last_stats.get("engine")}


def main(argv=None) -> int:
    from skoots_tpu_torch.tools.accuracy_campaign import _device_record, _relative
    from skoots_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.score_checkpoint",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--outdir", default="runs/convergence_torch")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint to score (default: the newest <outdir>/models/*.skoots)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to segment and score on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ckpts = sorted(glob.glob(os.path.join(args.outdir, "models", "*.skoots")))
    ckpt = args.ckpt or (ckpts[-1] if ckpts else None)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.outdir}/models and no --ckpt")
    result = segment_and_score(os.path.join(args.outdir, "val"), ckpt, device)
    result.update(checkpoint=_relative(ckpt, args.outdir), **_device_record(device))
    print(json.dumps(result))
    with open(os.path.join(args.outdir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
