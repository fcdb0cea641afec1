"""On the card, at each cell's own size: the control (the fp8 reference in
the program's place) comes out not correct on three seeds. Run there with
``python -m pytest -m cuda benchmark/tests/test_benchmark_card.py``; it
skips without a card. ``benchmark/calibrate.py`` gives the same readings
with the program's beside them."""

import time

import pytest

from benchmark import harness

CELLS = [w["name"] for w in __import__("json").load(open(harness.ROOT / "BENCHMARK.json"))
         ["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_s_size(cell, card):
    wl = harness.load_json("workloads", cell)
    entry = harness.load_module("entries", wl["entry"])
    for seed in (2**40 + 1, 2**40 + 2, 2**40 + 3):
        ctx = harness.Context(cell, wl, seed, 1.0, False, card, time.perf_counter())
        ctx.control = True
        assert not entry.run(ctx)["correct"]
