"""skoots_tpu_torch: the PyTorch/CUDA port of skoots-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``skoots_tpu``; it imports torch
and never jax or ``skoots_tpu``. Public layouts stay channels-last
``[B, X, Y, Z, C]`` as in the JAX package. The hot ops run in hand-written
CUDA kernels (``csrc/``, built at first use by ``kernels/_build.py``); on CPU
tensors every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
