"""The readers of the program's spans and counters on a filled tracer:
per unit over the traced window, nothing without a trace, nothing when the
root spans do not count the window's units, nothing from a program that
has no tracer."""

import sys

import pytest

from benchmark import harness

SEG = ("forward_issue_s_per_block", "release_cache_s_per_block", "host_syncs_per_block")
TRAIN = ("step_host_ms_per_step", "data_wait_ms_per_step", "augment_host_ms_per_step",
         "host_syncs_per_step")
TRACE = {"busy_s": 1.0, "window_s": 2.0, "kernels": {}}


def read(name, raw):
    return harness.load_module("metrics", name).read(raw)


@pytest.fixture
def tracer():
    from skoots_tpu_torch.utils import trace

    trace.reset()
    yield trace.TRACER
    trace.reset()


def _span(tracer, name, start_ns, end_ns, root=False):
    """A closed span of the given interval under the innermost open one."""
    rec = tracer._open(name, root)
    rec[1] = start_ns
    return rec, end_ns


def _close(tracer, opened, root=False):
    rec, end_ns = opened
    tracer._close(rec, root)
    rec[2] = end_ns


def _fill_seg(tracer, blocks):
    """``blocks`` blocks of 2 s: 3 tiles of 0.25 s, 3 releases of 0.1 s and
    5 host syncs each."""
    with tracer.recording():
        for b in range(blocks):
            t0 = b * 2_000_000_000
            block = _span(tracer, "seg.block", t0, t0 + 2_000_000_000, root=True)
            for k in range(3):
                _close(tracer, _span(tracer, "seg.tile", t0 + k, t0 + k + 250_000_000))
                _close(tracer, _span(tracer, "seg.release_cache", t0, t0 + 100_000_000))
            for _ in range(4):
                tracer.count("host_sync", "assign.nonzero")
            tracer.count("host_sync", "phase_clock.synchronize")
            _close(tracer, block, root=True)


def _fill_train(tracer, steps):
    """``steps`` steps: a 2-ms data wait, a 20-ms augmentation with 9
    syncs, a 60-ms step with 4."""
    with tracer.recording():
        for s in range(steps):
            t0 = s * 100_000_000
            _close(tracer, _span(tracer, "train.data_wait", t0, t0 + 2_000_000))
            aug = _span(tracer, "train.augment", t0, t0 + 20_000_000)
            for _ in range(9):
                tracer.count("host_sync", "augment.sample_h2d")
            _close(tracer, aug)
            step = _span(tracer, "train.step", t0, t0 + 60_000_000, root=True)
            for _ in range(4):
                tracer.count("host_sync", "vec2embed.sizes_h2d")
            _close(tracer, step, root=True)


def test_seg_readers_per_block(tracer):
    _fill_seg(tracer, 2)
    raw = {"unit": "seg_block", "blocks": 2, "trace": TRACE}
    assert read("forward_issue_s_per_block", raw) == pytest.approx(0.75)
    assert read("release_cache_s_per_block", raw) == pytest.approx(0.3)
    assert read("host_syncs_per_block", raw) == 5
    assert all(read(m, raw) is None for m in TRAIN)
    for changed in ({"trace": None}, {"blocks": 3}, {"blocks": 0}):
        assert all(read(m, dict(raw, **changed)) is None for m in SEG)


def test_train_readers_per_step(tracer):
    _fill_train(tracer, 4)
    raw = {"unit": "train_step", "steps": 4, "trace": TRACE}
    assert read("step_host_ms_per_step", raw) == pytest.approx(60.0)
    assert read("data_wait_ms_per_step", raw) == pytest.approx(2.0)
    assert read("augment_host_ms_per_step", raw) == pytest.approx(20.0)
    assert read("host_syncs_per_step", raw) == 13
    assert all(read(m, raw) is None for m in SEG)
    for changed in ({"trace": None}, {"steps": 5}):
        assert all(read(m, dict(raw, **changed)) is None for m in TRAIN)


def test_a_program_without_the_tracer_reads_nothing(tracer, monkeypatch):
    """The parent commit's program: no ``utils.trace`` to import."""
    import skoots_tpu_torch.utils as utils

    _fill_train(tracer, 1)
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "skoots_tpu_torch.utils.trace", None)
    raw = {"unit": "train_step", "steps": 1, "trace": TRACE}
    assert all(read(m, raw) is None for m in TRAIN)


def test_the_metrics_are_declared_for_their_cells():
    spec = harness.load_json(".", "BENCHMARK", harness.ROOT)
    layer = {m["name"]: m for m in spec["per_layer"]}
    for names, moves, cells, where in (
            (SEG, "seg_mvox_s", ["unext_seg_tubes512", "unext_seg_crowded512"], "pipeline"),
            (TRAIN, "train_step_ms", ["unext_train_300", "unet_train_300"],
             "training loop")):
        for n in names:
            assert layer[n]["moves"] == moves and layer[n]["workloads"] == cells
            assert layer[n]["layer"] == where and layer[n]["better"] == "lower"
            assert layer[n]["source"] == ("program_counter" if "syncs" in n else "program_span")
            for cell in cells:
                assert n in {m["name"] for m in harness.cell_metrics(spec, cell, True)}
