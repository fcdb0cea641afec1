"""Training of the port: ``python -m skoots_tpu_torch.train --config-file
cfg.yaml`` (``cli.py``), the engine (``engine.py``), on-device augmentation
(``transforms.py``) and the host data pipeline (``data.py``)."""
