"""``python -m skoots_tpu_torch``: the inference CLI (``cli.py``)."""

from skoots_tpu_torch.cli import main

raise SystemExit(main())
