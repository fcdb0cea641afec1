"""Host seconds the pipeline waits at a block's end for its instance mask's
last slabs to land in pinned host memory (the program's ``seg.mask_d2h``
spans), summed over the traced window, per block; no reading where the
program records no such span."""

from benchmark.metrics._spans import per_unit


def read(raw):
    found = per_unit(raw, "seg_block", "seg.block")
    if found is None:
        return None
    totals, units = found
    waits = totals["spans"].get("seg.mask_d2h")
    return None if waits is None else waits["s"] / units
