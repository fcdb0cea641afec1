"""``mask_d2h_s_per_block`` on a filled tracer: the ``seg.mask_d2h`` spans
per block; nothing from a program that records no such span, nothing
without a trace, nothing when the root spans do not count the window's
blocks."""

import pytest

from benchmark import harness

TRACE = {"busy_s": 1.0, "window_s": 2.0, "kernels": {}}
CELLS = ["unext_seg_tubes512", "unext_seg_crowded512"]


def read(raw):
    return harness.load_module("metrics", "mask_d2h_s_per_block").read(raw)


@pytest.fixture
def tracer():
    from skoots_tpu_torch.utils import trace

    trace.reset()
    yield trace.TRACER
    trace.reset()


def _fill(tracer, blocks, wait_ns):
    """``blocks`` blocks of 2 s, each a 0.25-s tile and, when ``wait_ns``, a
    wait of that many ns for the mask."""
    with tracer.recording():
        for b in range(blocks):
            t0 = b * 2_000_000_000
            block = tracer._open("seg.block", True)
            block[1] = t0
            for name, ns in (("seg.tile", 250_000_000), ("seg.mask_d2h", wait_ns)):
                if ns:
                    rec = tracer._open(name, False)
                    rec[1] = t0
                    tracer._close(rec, False)
                    rec[2] = t0 + ns
            tracer._close(block, True)
            block[2] = t0 + 2_000_000_000


def test_the_mask_waits_per_block(tracer):
    _fill(tracer, 2, 12_000_000)
    raw = {"unit": "seg_block", "blocks": 2, "trace": TRACE}
    assert read(raw) == pytest.approx(0.012)
    for changed in ({"trace": None}, {"blocks": 3}, {"blocks": 0},
                    {"unit": "train_step", "steps": 2}):
        assert read(dict(raw, **changed)) is None


def test_a_program_without_the_span_reads_nothing(tracer):
    """The parent commit's program: blocks, and no ``seg.mask_d2h``."""
    _fill(tracer, 2, 0)
    assert read({"unit": "seg_block", "blocks": 2, "trace": TRACE}) is None


def test_the_metric_is_declared_for_the_seg_cells():
    spec = harness.load_json(".", "BENCHMARK", harness.ROOT)
    m, = [m for m in spec["per_layer"] if m["name"] == "mask_d2h_s_per_block"]
    assert m == {"name": "mask_d2h_s_per_block", "unit": "s", "better": "lower",
                 "source": "program_span", "layer": "pipeline", "moves": "seg_mvox_s",
                 "workloads": CELLS}
    assert spec["per_layer"][-1] is m
    for cell in CELLS:
        assert m in harness.cell_metrics(spec, cell, True)
