"""``skoots-validate-torch``: instance-segmentation quality report (the
``skoots-validate`` surface of ``skoots_tpu/validate/cli.py`` on the port).

Crops the evaluation margin, computes the over/under-segmentation rates,
the IoU, Dice and clDice tables and a precision/recall/F1 sweep over 100
IoU thresholds on ``--device`` (default ``cuda``; without a card this
raises unless ``--device cpu`` is given), and writes the same two CSV
reports as ``skoots-validate`` and, unless ``--no-plots``, its PNG curves
(matplotlib, imported only then; a machine without it needs
``--no-plots``).

    python -m skoots_tpu_torch.validate -g gt.tif -p pred.tif --no-plots
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from skoots_tpu_torch.utils.device import resolve_device
from skoots_tpu_torch.utils.io import imread
from skoots_tpu_torch.validate.metrics import (
    accuracies_from_iou,
    as_tensor,
    contingency,
    dice_table,
    f1_score,
    iou_table,
    mask_soft_cldice,
    segmentation_errors,
)

log = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="skoots-validate-torch", description=__doc__)
    p.add_argument("--ground_truth", "-g", type=str, required=True)
    p.add_argument("--predicted", "-p", type=str, required=True)
    p.add_argument("--log", type=int, default=3)
    p.add_argument(
        "--margin",
        type=int,
        nargs=3,
        default=[50, 50, 5],
        help="evaluation margin cropped from each side (x y z); reference uses 50 50 5",
    )
    p.add_argument("--no-plots", action="store_true", help="skip PNG curve output")
    p.add_argument("--no-cldice", action="store_true", help="skip (slow) clDice table")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; without a "
                        "CUDA card this raises unless --device cpu is given)")
    return p


def _plot_curves(out_stem: str, precision, recall, f1) -> None:
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the precision/recall/F1 curves need matplotlib, which is not "
            "installed; pass --no-plots to write the CSV reports only") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xaxis = np.arange(100)
    for name, ys in (("precision", precision), ("recall", recall), ("f1", f1)):
        fig = plt.figure()
        plt.plot(xaxis, ys, "k-")
        plt.title(name.capitalize())
        plt.xlabel("Threshold (%)")
        plt.ylabel("Score")
        plt.tight_layout()
        plt.savefig(f"{out_stem}_{name}.png", dpi=300)
        plt.close(fig)


def run_validation(
    gt,
    pred,
    out_stem: str,
    gt_path: str = "",
    pred_path: str = "",
    plots: bool = True,
    cldice: bool = True,
    device=None,
) -> dict:
    """Score ``pred`` against ``gt`` (label volumes of one shape) on
    ``device``, write ``<out_stem>_accuracy_stats.csv`` and
    ``<out_stem>_intersection_over_union.csv`` (and the PNG curves with
    ``plots``), and return the summary."""
    dev = resolve_device(device)
    gt, pred = as_tensor(gt, dev), as_tensor(pred, dev)
    # one contingency pass feeds every table
    table = contingency(gt, pred, dev)
    iou_dev = iou_table(*table[2:])
    over, under = segmentation_errors(iou_dev)
    iou = iou_dev.cpu().numpy()
    dice = dice_table(*table[2:]).cpu().numpy()
    cl = (mask_soft_cldice(gt, pred, device=dev, table=table).cpu().numpy()
          if cldice else np.zeros_like(iou))
    gt_ids = table[0].cpu().numpy()

    tfp = [accuracies_from_iou(iou_dev, thr / 100) for thr in range(100)]
    precision = [tp / (tp + fp) if (tp + fp) else 0.0 for tp, fp, fn in tfp]
    recall = [tp / (tp + fn) if (tp + fn) else 0.0 for tp, fp, fn in tfp]
    f1 = [f1_score(*a) for a in tfp]

    if plots:
        _plot_curves(out_stem, precision, recall, f1)

    with open(f"{out_stem}_accuracy_stats.csv", "w") as f:
        f.write(f"Ground Truth File: {gt_path}\n")
        f.write(f"Predicted File: {pred_path}\n")
        f.write(f"Over Segmentation Rate: {over}\n")
        f.write(f"Under Segmentation Rate: {under}\n")
        f.write("thr,true_positive,false_positive,false_negative,precision,recall,f1\n")
        for i, ((tp, fp, fn), pr, rc, f1v) in enumerate(zip(tfp, precision, recall, f1)):
            f.write(f"{i / 100},{tp},{fp},{fn},{pr},{rc},{f1v}\n")

    mean_iou = float(iou.max(axis=1).mean()) if iou.size else 0.0
    mean_dice = float(dice.max(axis=1).mean()) if dice.size else 0.0
    mean_cl = float(cl.max(axis=1).mean()) if cl.size else 0.0
    with open(f"{out_stem}_intersection_over_union.csv", "w") as f:
        f.write(f"Ground Truth File: {gt_path}\n")
        f.write(f"Predicted File: {pred_path}\n")
        f.write(f"Average IOU: {mean_iou}\n")
        f.write(f"Average Dice: {mean_dice}\n")
        f.write(f"Average clDice: {mean_cl}\n")
        f.write("gt_label,best_iou,best_dice,best_cldice\n")
        for i, u in enumerate(gt_ids):
            bi = iou[i].max() if iou.shape[1] else 0.0
            bd = dice[i].max() if dice.shape[1] else 0.0
            bc = cl[i].max() if cl.shape[1] else 0.0
            f.write(f"{u},{bi},{bd},{bc}\n")

    return {
        "over_segmentation_rate": over,
        "under_segmentation_rate": under,
        "mean_iou": mean_iou,
        "mean_dice": mean_dice,
        "mean_cldice": mean_cl,
        "f1@50": f1[50],
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=[logging.DEBUG, logging.INFO, logging.WARNING,
                               logging.ERROR, logging.CRITICAL][min(args.log, 4)])
    device = resolve_device(args.device)
    if not (os.path.exists(args.ground_truth) and os.path.exists(args.predicted)):
        raise RuntimeError(
            f"missing input: gt={os.path.exists(args.ground_truth)}, "
            f"pred={os.path.exists(args.predicted)}"
        )
    gt = imread(args.ground_truth).astype(np.int64)
    pred = imread(args.predicted).astype(np.int64)
    margin = tuple(args.margin)
    if all(2 * m < s for m, s in zip(margin, gt.shape)):
        sl = tuple(slice(m, -m if m else None) for m in margin)
        gt, pred = gt[sl], pred[sl]

    stem = os.path.splitext(args.predicted)[0]
    res = run_validation(
        gt, pred, stem, args.ground_truth, args.predicted,
        plots=not args.no_plots, cldice=not args.no_cldice, device=device,
    )
    print(
        f"over-seg rate: {res['over_segmentation_rate']:.4f}  "
        f"under-seg rate: {res['under_segmentation_rate']:.4f}\n"
        f"mean IoU: {res['mean_iou']:.4f}  mean Dice: {res['mean_dice']:.4f}  "
        f"mean clDice: {res['mean_cldice']:.4f}  F1@0.5: {res['f1@50']:.4f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
