"""Model FLOPs and the per-level shapes of the two backbones, from a cfg.

FLOPs count the multiply-adds of convolutions and matmuls as 2 each (norms,
activations, upsamples, pools and the walk are left out). ``levels`` gives
the (voxel fraction of the input, channels) of each ConvNeXt or conv stage,
so the kernel families can reckon their work from the cfg alone.
"""

from __future__ import annotations

HEAD_OUT = 5  # vectors 3, skeleton 1, semantic 1


def _kd(m):
    return len(m["DIMS"]) // 2


def unext_blocks(m):
    """[(fraction, C)] of every ConvNeXt block, in forward order."""
    dims, depths, kd = m["DIMS"], m["DEPTHS"], _kd(m)
    out = []
    for s in range(kd):
        out += [(8.0 ** -s, dims[s])] * depths[s]
    out += [(8.0 ** -kd, dims[kd])] * depths[kd]
    for s in range(kd):
        out += [(8.0 ** -(kd - 1 - s), dims[kd + 1 + s])] * depths[kd + 1 + s]
    return out


def upsamples(m):
    """[(fraction of the input voxels at the upsample's input, C)]."""
    dims, kd = m["DIMS"], _kd(m)
    return [(8.0 ** -(kd - s), dims[kd + s]) for s in range(kd)]


def unet_convs(m):
    """[(fraction, Cin, Cout)] of every 3^3 conv of UNet3D, in order."""
    dims, depths, kd = m["DIMS"], m["DEPTHS"], _kd(m)
    out = []
    c = m["IN_CHANNELS"]

    def stage(frac, din, dim, depth):
        for i in range(depth):
            out.append((frac, din if i == 0 else dim, dim))
        return dim if depth else din

    for s in range(kd):
        c = stage(8.0 ** -s, c, dims[s], depths[s])
    c = stage(8.0 ** -kd, c, dims[kd], depths[kd])
    for s in range(kd):
        c = stage(8.0 ** -(kd - 1 - s), c + dims[kd - 1 - s], dims[kd + 1 + s],
                  depths[kd + 1 + s])
    return out, c


def forward_flops_per_voxel(m) -> float:
    """Forward FLOPs per input voxel of ``SpatialEmbedding(backbone)``."""
    k3 = m["KERNEL_SIZE"] ** 3
    dims, kd = m["DIMS"], _kd(m)
    out_c = m["OUT_CHANNELS"]
    if m["ARCHITECTURE"] in ("bism_unet", "unet"):
        kk = min(m["KERNEL_SIZE"], 3) ** 3
        convs, last = unet_convs(m)
        f = sum(2.0 * kk * ci * co * fr for fr, ci, co in convs)
        return f + 2.0 * last * out_c + 2.0 * out_c * HEAD_OUT
    f = 2.0 * k3 * dims[0] * m["IN_CHANNELS"]
    f += sum((2.0 * k3 * c + 16.0 * c * c) * fr for fr, c in unext_blocks(m))
    for s in range(kd):
        f += 2.0 * 8 * dims[s] * dims[s + 1] * 8.0 ** -(s + 1)
        cin = dims[kd + s] + dims[kd - 1 - s]
        f += 2.0 * cin * dims[kd + 1 + s] * 8.0 ** -(kd - 1 - s)
    return f + 2.0 * dims[-1] * out_c + 2.0 * out_c * HEAD_OUT


def itemsize(m) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[m.get("DTYPE", "bfloat16")]


def unit_voxels(raw) -> tuple:
    """(input voxels the kernels run over a unit, whether it trains): a
    segmentation block's tiles, or a training step's crop times batch."""
    if raw["unit"] == "seg_block":
        t = raw["tile"]
        return float(t[0] * t[1] * t[2] * raw["tiles_per_block"]), False
    c = raw["crop"]
    return float(c[0] * c[1] * c[2] * raw["batch"]), True
