"""Shared by the readers of the program's own spans and counters
(``skoots_tpu_torch/utils/trace.py``): the tracer's totals, read in the
run's process after the entry returns. The program records only while a
profiler runs, so they cover the traced window alone: the warm-up and the
judged pass run without one."""


def per_unit(raw, unit, root):
    """``(totals, units)``: the tracer's totals and the window's count of
    units (``raw["blocks"]`` or ``raw["steps"]``), or None when the run was
    not traced, the program has no tracer, or its count of ``root`` spans
    is not the window's count of units."""
    if raw["unit"] != unit or raw.get("trace") is None:
        return None
    try:
        from skoots_tpu_torch.utils import trace
    except ImportError:
        return None
    totals = trace.totals()
    units = raw["blocks"] if unit == "seg_block" else raw["steps"]
    if totals["spans"].get(root, {}).get("n") != units or not units:
        return None
    return totals, units


def span_s(raw, unit, root, name):
    """Seconds of the spans ``name`` a unit, or None (:func:`per_unit`)."""
    found = per_unit(raw, unit, root)
    if found is None:
        return None
    totals, units = found
    return totals["spans"].get(name, {}).get("s", 0.0) / units


def syncs(raw, unit, root):
    """Counts of ``host_sync`` a unit, all sites, or None (:func:`per_unit`)."""
    found = per_unit(raw, unit, root)
    if found is None:
        return None
    totals, units = found
    return sum(totals["counters"].get("host_sync", {}).values()) / units
