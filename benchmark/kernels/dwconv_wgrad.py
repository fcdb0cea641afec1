"""The depthwise and stem weight gradients (``csrc/dwconv_wgrad.cu``).

Work a training step: for the stem and every ConvNeXt block's depthwise
conv, read the layer's input and the output's cotangent once and write the
``[k, k, k, C]`` gradient; ``k^3`` multiply-adds a cotangent value on the
tensor cores.
"""

from benchmark.flops import itemsize, unext_blocks, unit_voxels

PATTERN = (r"\b(dwconv3d_wgrad(_tc|_big|_any)?_kernel|stem_wgrad(_tc|_chunk)_kernel"
           r"|wgrad_reduce_kernel)\b")


def work(m, raw):
    v, train = unit_voxels(raw)
    if not train or m["ARCHITECTURE"] not in ("bism_unext", "unext"):
        return []
    b, k3 = itemsize(m), m["KERNEL_SIZE"] ** 3
    c0 = m["DIMS"][0]
    out = [(v * (m["IN_CHANNELS"] + c0) * b + k3 * c0 * 4, 0.0, 2.0 * k3 * c0 * v)]
    return out + [(v * fr * 2 * c * b + k3 * c * 4, 0.0, 2.0 * k3 * c * v * fr)
                  for fr, c in unext_blocks(m)]
