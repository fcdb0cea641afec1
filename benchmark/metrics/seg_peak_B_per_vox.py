"""The card's reserved peak over the window (peaks reset after warm-up)
over the voxels of one block."""


def read(raw):
    if raw["unit"] != "seg_block" or not raw["peak_reserved_window"]:
        return None
    return raw["peak_reserved_window"] / raw["voxels_per_block"]
