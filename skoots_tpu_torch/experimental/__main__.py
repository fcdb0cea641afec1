"""``python -m skoots_tpu_torch.experimental``: the experimental entry
point (port of ``skoots_tpu/experimental/__main__.py``). Two modes:

* ``--config-file cfg.yaml``: sparse training, with
  ``EXPERIMENTAL.IS_SPARSE`` forced on;
* ``--image I.tif --pretrained-checkpoint M.skoots``: inference with the
  tuned knobs, as ``skoots-torch --experimental``.

``--device`` (default ``cuda``) picks the card; ``--device cpu`` runs every
kernel's plain version on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="skoots_tpu_torch.experimental", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", type=str, default=None,
                   help="YAML config for sparse training")
    p.add_argument("--image", type=str, default=None,
                   help="volume to segment with the experimental knob set")
    p.add_argument("--pretrained-checkpoint", dest="pretrained_checkpoint", type=str,
                   default=None)
    p.add_argument("--use-cached", action="store_true", dest="use_cached")
    p.add_argument("--log", type=int, default=2)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=[logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][min(args.log, 3)],
        format="[%(asctime)s] skoots-experimental [%(levelname)s]: %(message)s",
    )
    if args.config_file:
        from skoots_tpu_torch.config import load_cfg_from_file
        from skoots_tpu_torch.experimental.sparse_engine import train_sparse

        cfg = load_cfg_from_file(args.config_file, freeze=False)
        cfg["EXPERIMENTAL"]["IS_SPARSE"] = True
        train_sparse(cfg, steps_per_epoch=args.steps_per_epoch, device=args.device)
        return 0
    if args.image and args.pretrained_checkpoint:
        from skoots_tpu_torch.experimental.eval import eval as experimental_eval

        experimental_eval(args.image, args.pretrained_checkpoint,
                          use_cached_data=args.use_cached, device=args.device)
        return 0
    print("usage: python -m skoots_tpu_torch.experimental --config-file cfg.yaml\n"
          "       python -m skoots_tpu_torch.experimental --image I.tif "
          "--pretrained-checkpoint M.skoots", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
