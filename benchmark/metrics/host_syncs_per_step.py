"""The program's ``host_sync`` counts (copies from the host in the
augmentation and the loss, boolean indexes, ...) over the traced window,
per train step."""

from benchmark.metrics._spans import syncs


def read(raw):
    return syncs(raw, "train_step", "train.step")
