"""The fused final LayerNorm and 1x1 head of UNeXT3D (``csrc/lnhead.cu``),
forward only.

Work a forward: read ``DIMS[-1]`` channels and write ``OUT_CHANNELS`` a
voxel; the matmul on the tensor cores.
"""

from benchmark.flops import itemsize, unit_voxels

PATTERN = r"\bln_head_(tc|class|f32)_kernel\b"


def work(m, raw):
    if m["ARCHITECTURE"] not in ("bism_unext", "unext"):
        return []
    v, _ = unit_voxels(raw)
    c, n = m["DIMS"][-1], m["OUT_CHANNELS"]
    return [(v * (c + n) * itemsize(m), 0.0, 2.0 * c * n * v)]
