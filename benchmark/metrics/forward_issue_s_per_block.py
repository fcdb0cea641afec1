"""Host seconds inside the forward's tiles (the program's ``seg.tile``
spans: the model call, ``tile_masks`` and the stores), summed over the
traced window, per block (``seg.block`` spans). Near ``forward_s_per_block``
the host paces the forward; far below it, the card does."""

from benchmark.metrics._spans import span_s


def read(raw):
    return span_s(raw, "seg_block", "seg.block", "seg.tile")
