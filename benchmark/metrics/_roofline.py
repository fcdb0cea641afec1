"""Shared by the ``kernel_roofline_pct.*`` readers: the least seconds the
work of the listed hand-written kernel families needs, over their device
seconds in the trace. Each reader names its families, so that a family file
added later (``benchmark/kernels/<family>.py``) comes with a metric of its
own and leaves the old ones as they were."""

import re

from benchmark.harness import bound_s, load_module


def roofline_pct(raw, unit, families):
    tr = raw.get("trace")
    if raw["unit"] != unit or tr is None:
        return None
    units = raw["blocks"] if unit == "seg_block" else raw["steps"]
    least = spent = 0.0
    for fam in families:
        mod = load_module("kernels", fam)
        t = sum(s for n, s in tr["kernels"].items() if re.search(mod.PATTERN, n))
        if t <= 0:
            continue
        spent += t
        least += units * sum(bound_s(*w) for w in mod.work(raw["model"], raw))
    return 100.0 * least / spent if spent > 0 else None
