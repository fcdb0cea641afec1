"""Sparse (weakly supervised) training and the tuned ``--experimental``
inference of the port (``skoots_tpu/experimental``): ``data.py`` (sparse
volumes), ``modifiers.py`` (background ablations), ``sparse_loss.py``,
``sparse_engine.py`` (augmentation, train step, threshold calibrator,
``train_sparse``), ``eval.py`` (the tuned knobs) and ``__main__.py``."""
