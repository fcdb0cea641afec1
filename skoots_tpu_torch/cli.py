"""``skoots-torch`` console entry point: the ``skoots --image`` inference
surface of ``skoots_tpu/cli.py:26-196`` on the PyTorch/CUDA port.

Every argument of the JAX CLI is accepted, plus ``--device`` (default
``cuda``; ``--device cpu`` runs every kernel's plain version on the CPU).
The ones whose feature is not ported yet (``--skeletonize-train-data``,
``--convert``, ``--experimental``, the ``device-thrifty`` engine,
``--spatial-shards`` > 1) raise ``NotImplementedError``; see ROADMAP.md.

    python -m skoots_tpu_torch --image vol.tif --pretrained-checkpoint m.skoots
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys

_LOG_LEVELS = {
    0: logging.ERROR,
    1: logging.WARNING,
    2: logging.INFO,
    3: logging.DEBUG,
    4: logging.DEBUG,
}

_NOT_PORTED = "is not ported to skoots_tpu_torch yet (see ROADMAP.md)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="skoots-torch", description=__doc__)
    p.add_argument("--image", type=str, help="image (or directory of .tif) to segment")
    p.add_argument(
        "--pretrained-checkpoint",
        dest="pretrained_checkpoint",
        type=str,
        help="path to a skoots-tpu checkpoint (.skoots)",
    )
    p.add_argument("--use-cached", action="store_true", dest="use_cached",
                   help="reuse cached phase-1 vector/skeleton buffers")
    p.add_argument("--fast-embed-walk", action="store_true",
                   dest="fast_embed_walk",
                   help="enable the convergence early exit of the embedding "
                        "walk (skips steps once <0.1%% of voxels still move; "
                        "default runs all N steps — reference semantics, "
                        "eval.py:271-273)")
    p.add_argument("--cycle-exit-walk", action="store_true",
                   dest="cycle_exit_walk",
                   help="with --fast-embed-walk, also treat period-2 index "
                        "oscillations as converged (trained fields pin the "
                        "moving fraction at the fg fraction otherwise; "
                        "label-exact on measured fields, "
                        "runs/bench_assign.json)")
    p.add_argument("--out-of-core", dest="out_of_core", default=None,
                   action="store_true",
                   help="force disk-backed buffers (default: auto over 256^3)")
    p.add_argument("--engine", dest="engine_impl",
                   choices=("auto", "host", "device", "device-thrifty"),
                   default="auto",
                   help="execution engine: 'device' = whole-volume on-device "
                        "pipeline (volume + all intermediates in HBM, no "
                        "per-tile host traffic); 'host' = tile-streaming "
                        "3-phase engine (any volume size). Default auto: "
                        "host up to 256^3 voxels, with --use-cached buffers "
                        "or --out-of-core; above that device when the volume "
                        "fits device memory")
    p.add_argument("--wire-mode", dest="wire_mode",
                   choices=("auto", "store", "recompute"), default="auto",
                   help="host<->device traffic policy for the streaming "
                        "engine: 'store' persists the f16 vector field and "
                        "reads it back in phase 3 (reference zarr semantics); "
                        "'recompute' ships only bit-packed masks and re-runs "
                        "the forward on device per assign tile. Default auto: "
                        "recompute for out-of-core volumes")
    p.add_argument("--skeletonize-train-data", type=str, default=None,
                   help="directory of *<mask-filter>.tif to precompute GT "
                        "skeletons for")
    p.add_argument("--mask-filter", dest="mask_filter", default=".labels",
                   help="suffix distinguishing mask files from images "
                        "(reference __main__.py:55-57): skeletonization "
                        "globs *<mask-filter>.tif; --image DIR skips them")
    p.add_argument("--downscaleXY", type=float, default=1.0)
    p.add_argument("--downscaleZ", type=float, default=1.0)
    p.add_argument("--skeletonize-method", dest="skeletonize_method",
                   choices=("lee", "medial", "teasar"), default="lee",
                   help="GT skeletonizer: true Lee 3D thinning (the "
                        "reference's skimage choice; default), EDT-ridge "
                        "medial axis (faster), or TEASAR centerlines")
    p.add_argument("--convert", type=str, default=None,
                   help="convert a saved tensor/volume artifact to tif")
    p.add_argument("--log", type=int, default=2, help="log level 0-4")
    p.add_argument("--batch", type=int, default=1, help="tiles per device batch")
    p.add_argument("--spatial-shards", dest="spatial_shards", type=int,
                   default=None,
                   help="shard the volume's X axis over this many devices "
                        "(multi-chip spatially-partitioned inference). "
                        "Default: auto — all devices when >1 is present and "
                        "the volume fits the sharded pipeline's per-device "
                        "memory ceiling; 0 forces the host-streaming engine")
    p.add_argument("--dilate-3d", dest="dilation_3d", type=int, default=None,
                   help="3D dilation steps applied to the thresholded skeleton "
                        "map before connected components. Default: auto — "
                        "derived from the predicted skeleton spacing measured "
                        "on probe tiles (infer/autoknobs.py); the reference's "
                        "fixed stack is 1 (eval.py:152-157). Each step bridges "
                        "~2 voxels: keep total dilation below half the minimum "
                        "inter-skeleton gap or adjacent instances merge")
    p.add_argument("--dilate-2d", dest="dilation_2d", type=int, default=None,
                   help="in-plane (XY) dilation steps after the 3D steps "
                        "(default: auto; reference fixed stack is 2, "
                        "eval.py:152-157)")
    p.add_argument("--semantic-threshold", dest="semantic_threshold",
                   type=float, default=None,
                   help="semantic foreground-gate probability level. "
                        "Default: auto — a sparse checkpoint's self-"
                        "calibrated value when recorded (sparse training "
                        "calibrates the level whose foreground volume "
                        "matches the supervised DIST_THR ball), else the "
                        "standard 0.8")
    p.add_argument("--min-instance-size", dest="min_instance_size",
                   type=int, default=-1,
                   help="drop instances below this voxel count before the "
                        "final renumber. Default -1: auto — 1%% of the "
                        "75th-percentile instance size (capped at 64), a no-op "
                        "unless speck instances two orders of magnitude "
                        "below typical exist (textured-data skeleton "
                        "specks). 0 disables (the reference never filters, "
                        "eval.py:245-310)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; without a "
                        "CUDA card this raises unless --device cpu is given)")
    p.add_argument("--experimental", action="store_true",
                   help="use the experimental tuned knob set (prob 0.5, "
                        "3x 2D dilation, decaying embedding walk — reference "
                        "experimental/eval.py:138-146,253-255); explicit "
                        "flags still override")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=_LOG_LEVELS.get(args.log, logging.INFO),
        format="[%(asctime)s] %(levelname)s [%(name)s]: %(message)s",
    )
    if args.skeletonize_train_data:
        raise NotImplementedError(f"--skeletonize-train-data {_NOT_PORTED}")
    if args.convert:
        raise NotImplementedError(f"--convert {_NOT_PORTED}")
    if args.experimental:
        raise NotImplementedError(f"--experimental {_NOT_PORTED}")
    if not args.image or not args.pretrained_checkpoint:
        print("usage: skoots-torch --image I.tif --pretrained-checkpoint M.skoots",
              file=sys.stderr)
        return 2

    from skoots_tpu_torch.infer.engine import run_inference

    if os.path.isdir(args.image):
        files = sorted(glob.glob(os.path.join(args.image, "*.tif")))
        files = [f for f in files if args.mask_filter + "." not in f]
    else:
        files = [args.image]

    for f in files:
        run_inference(
            f,
            args.pretrained_checkpoint,
            use_cached_data=args.use_cached,
            batch=args.batch,
            spatial_shards=args.spatial_shards,
            embed_exit_fraction=1e-3 if args.fast_embed_walk else None,
            embed_exit_cycle=args.cycle_exit_walk,
            out_of_core=args.out_of_core,
            dilation_3d=args.dilation_3d,
            dilation_2d=args.dilation_2d,
            semantic_threshold=args.semantic_threshold,
            wire_mode=args.wire_mode,
            engine_impl=args.engine_impl,
            min_instance_size=args.min_instance_size,
            device=args.device,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
