"""Host ms inside the program's ``train.step`` spans (issuing the forward,
loss, backward and update), over the traced window, per step. Taken under
the profiler, whose per-op cost makes the host the step's pace-setter: it
reads about twice the untraced host time (UNeXT 122–143 ms traced against
57 ms untraced with recording on, H100), so it measures the issue work the
profiler sees, not the step as users run it."""

from benchmark.metrics._spans import span_s


def read(raw):
    s = span_s(raw, "train_step", "train.step", "train.step")
    return None if s is None else 1e3 * s
