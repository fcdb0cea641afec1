"""The program's ``host_sync`` counts (every site where the host waits for
the card: synchronises, CC polls, ``nonzero``, copies from the host,
``empty_cache``) over the traced window, per block."""

from benchmark.metrics._spans import syncs


def read(raw):
    return syncs(raw, "seg_block", "seg.block")
