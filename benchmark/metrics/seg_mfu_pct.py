"""Segmentation: forward FLOPs a voxel times the blocks' voxels, over the
traced window at the bf16 peak."""

from benchmark.metrics._mfu import mfu_pct


def read(raw):
    return mfu_pct(raw, "seg_block")
