"""Training: three times the forward FLOPs over crop times batch a step,
over the traced window at the bf16 peak."""

from benchmark.metrics._mfu import mfu_pct


def read(raw):
    return mfu_pct(raw, "train_step")
