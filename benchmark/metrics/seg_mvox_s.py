"""Voxels of all blocks finished in the window over the window's seconds,
in millions a second (host clock; the window ends after its last block's
mask is on the host)."""


def read(raw):
    if raw["unit"] != "seg_block":
        return None
    return raw["blocks"] * raw["voxels_per_block"] / raw["window_s"] / 1e6
