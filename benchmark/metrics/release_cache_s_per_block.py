"""Host seconds in the pipeline's allocator releases (the program's
``seg.release_cache`` spans around ``torch.cuda.empty_cache``, three a
block), summed over the traced window, per block."""

from benchmark.metrics._spans import span_s


def read(raw):
    return span_s(raw, "seg_block", "seg.block", "seg.release_cache")
