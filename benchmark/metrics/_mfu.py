"""Shared by the ``*_mfu_pct`` readers: the model's FLOPs in the traced
window over the window's seconds at the bf16 dense peak (989 TFLOP/s)."""

from benchmark.flops import forward_flops_per_voxel
from benchmark.harness import PEAK_BF16_FLOP_S


def mfu_pct(raw, unit):
    if raw["unit"] != unit or raw.get("trace") is None:
        return None
    per_vox = forward_flops_per_voxel(raw["model"])
    if unit == "seg_block":
        flops = per_vox * raw["voxels_per_block"] * raw["blocks"]
    else:
        c = raw["crop"]
        flops = 3.0 * per_vox * c[0] * c[1] * c[2] * raw["batch"] * raw["steps"]
    return 100.0 * flops / (raw["window_s"] * PEAK_BF16_FLOP_S)
