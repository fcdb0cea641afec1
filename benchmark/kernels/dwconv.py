"""The depthwise k^3 convolutions and the stem (``csrc/dwconv.cu``).

Work a unit: the stem (one input channel to ``DIMS[0]``) and every
ConvNeXt block's depthwise conv of the forward; a training step adds each
depthwise conv's input gradient (a depthwise conv of the cotangent with the
flipped weights; the stem's input needs none). Each reads its input and
writes its output once, ``k^3`` multiply-adds an output value on the
tensor cores. UNet3D has no depthwise conv: its cells launch none.
"""

from benchmark.flops import itemsize, unext_blocks, unit_voxels

PATTERN = r"\b(dwconv3d(_tc|_big|_any)?_kernel|stem_gemm(_chunk)?_kernel)\b"


def work(m, raw):
    """[(bytes, fp32 FLOPs, tensor FLOPs)] a launch of one unit."""
    if m["ARCHITECTURE"] not in ("bism_unext", "unext"):
        return []
    v, train = unit_voxels(raw)
    b, k3 = itemsize(m), m["KERNEL_SIZE"] ** 3
    c0 = m["DIMS"][0]
    out = [(v * (m["IN_CHANNELS"] + c0) * b, 0.0, 2.0 * k3 * c0 * v)]
    blocks = [(v * fr * 2 * c * b, 0.0, 2.0 * k3 * c * v * fr) for fr, c in unext_blocks(m)]
    return out + blocks * (2 if train else 1)
