"""The fused ConvNeXt block tail: LayerNorm, Dense 4C, GELU, Dense C,
layer scale and residual (``csrc/mlp.cu``), forward only (its backward is
plain autograd).

Work a block: read the conv output and the shortcut, write the output;
16 C^2 tensor-core FLOPs a voxel (the two matmuls) and 34 C FP32 FLOPs a
voxel for the arithmetic around them that the function needs, whatever
implements it, each operation counted once and erf as one: the LayerNorm
7 a channel (sum, centre, square, sum, scale, weight, bias), the first
bias and the erf-GELU 0.5 x (1 + erf(x / sqrt 2)) 1 + 5 a hidden value (4 C
of them), the second bias, the layer scale and the residual 3 an output.
"""

from benchmark.flops import itemsize, unext_blocks, unit_voxels

PATTERN = r"\btail_(tc|class|staged|f32)_kernel\b"
EPILOGUE_FLOPS = 7 + 4 * (1 + 5) + 3  # a channel C, a voxel


def work(m, raw):
    if m["ARCHITECTURE"] not in ("bism_unext", "unext"):
        return []
    v, _ = unit_voxels(raw)
    b = itemsize(m)
    return [(3.0 * v * fr * c * b, EPILOGUE_FLOPS * c * v * fr, 16.0 * c * c * v * fr)
            for fr, c in unext_blocks(m)]
