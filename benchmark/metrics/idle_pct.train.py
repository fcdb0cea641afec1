"""Training cells: the device's idle share of the traced window."""

from benchmark.metrics._idle import idle_pct


def read(raw):
    return idle_pct(raw, "train_step")
