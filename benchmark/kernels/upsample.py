"""The 2x trilinear upsample of the decoder (``csrc/upsample.cu``), forward
only (its backward is plain autograd); both backbones launch it.

Work a forward: read the coarse input once and write the 8x output.
"""

from benchmark.flops import itemsize, unit_voxels, upsamples

PATTERN = r"\bupsample2x_kernel\b"


def work(m, raw):
    v, _ = unit_voxels(raw)
    return [(9.0 * v * fr * c * itemsize(m), 0.0, 0.0) for fr, c in upsamples(m)]
