"""Shared by the ``idle_pct.*`` readers: the share of the traced window in
which no kernel ran (the union of the profiler's kernel intervals)."""


def idle_pct(raw, unit):
    tr = raw.get("trace")
    if raw["unit"] != unit or tr is None:
        return None
    return 100.0 * max(0.0, tr["window_s"] - tr["busy_s"]) / tr["window_s"]
