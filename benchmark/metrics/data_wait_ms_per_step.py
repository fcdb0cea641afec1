"""Host ms the step loop waits for its host batch (the program's
``train.data_wait`` spans, blocked on the prefetch queue), over the traced
window, per step."""

from benchmark.metrics._spans import span_s


def read(raw):
    s = span_s(raw, "train_step", "train.step", "train.data_wait")
    return None if s is None else 1e3 * s
