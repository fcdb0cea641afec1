"""Host ms inside the batch augmentation (the program's ``train.augment``
spans: the copies to the card, the geometric core, the bake and the
skeleton mask), over the traced window, per step; the inside counterpart
of ``augment_ms_per_step``'s CUDA events. Taken under the profiler, so
not the augmentation as users run it: untraced its first copy waits for
the previous step's kernels and it reads more (UNeXT 42–54 ms traced
against 75.6 ms untraced with recording on, H100); traced, the host is
the pace-setter and the wait shrinks."""

from benchmark.metrics._spans import span_s


def read(raw):
    s = span_s(raw, "train_step", "train.step", "train.augment")
    return None if s is None else 1e3 * s
