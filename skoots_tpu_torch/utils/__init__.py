"""Host utilities of the port (``skoots_tpu/utils``): volume I/O
(``io.py``, TIFF through ``tiff.py`` without Pillow), phantoms, the
``.trch`` converter (``torch_compat.py``) and the finishers."""

from skoots_tpu_torch.utils.io import imread, imsave

__all__ = ["imread", "imsave"]
