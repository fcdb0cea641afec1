"""Training cells: the hand-written kernels' share of their roofline."""

from benchmark.metrics._roofline import roofline_pct


FAMILIES = ("dwconv", "dwconv_wgrad", "tail", "ln_head", "upsample")


def read(raw):
    return roofline_pct(raw, "train_step", FAMILIES)
