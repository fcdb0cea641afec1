"""The CC's rounds (``run.last_cc_rounds``) summed over the window's
blocks, per block: a count."""


def read(raw):
    if raw["unit"] != "seg_block" or not raw["cc_rounds"]:
        return None
    return sum(raw["cc_rounds"]) / len(raw["cc_rounds"])
