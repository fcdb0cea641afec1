"""The pipeline's ``2-cc`` plus ``3-assign`` seconds summed over the
window's blocks, per block."""


def read(raw):
    if raw["unit"] != "seg_block" or not raw["phases"]:
        return None
    return sum(p["2-cc"] + p["3-assign"] for p in raw["phases"]) / len(raw["phases"])
