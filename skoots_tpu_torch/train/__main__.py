"""``python -m skoots_tpu_torch.train``: the training CLI (``cli.py``)."""

from skoots_tpu_torch.train.cli import main

raise SystemExit(main())
