"""The pipeline's own ``1-forward`` seconds (``run.last_phase_s``, host
clock between synchronisations) summed over the window's blocks, per
block."""


def read(raw):
    if raw["unit"] != "seg_block" or not raw["phases"]:
        return None
    return sum(p["1-forward"] for p in raw["phases"]) / len(raw["phases"])
