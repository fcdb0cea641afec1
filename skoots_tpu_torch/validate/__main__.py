"""``python -m skoots_tpu_torch.validate``: the validation CLI (``cli.py``)."""

from skoots_tpu_torch.validate.cli import main

raise SystemExit(main())
