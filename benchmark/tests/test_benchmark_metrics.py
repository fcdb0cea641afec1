"""The metric readers and the trace reduction on made-up raw records."""

import json

import pytest

from benchmark import harness

MODEL = json.load(open(harness.BENCH / "configs" / "skoots_unext.json"))["cfg"]["MODEL"]


def read(name, raw):
    return harness.load_module("metrics", name).read(raw)


def test_trace_reduction_busy_gaps_and_labels():
    ev = [(0, 10, "k1", True), (5, 20, "k2", True), (40, 50, "k1", True),
          (25, 35, "cudaStreamSynchronize", False), (0, 100, "step", False)]
    tr = harness.reduce_events(ev, 1e-7)
    assert tr["busy_s"] == pytest.approx(30e-9)
    assert tr["kernels"] == {"k1": pytest.approx(20e-9), "k2": pytest.approx(15e-9)}
    assert tr["idle_gaps"] == [["host: cudaStreamSynchronize", pytest.approx(20e-9)]]
    assert [n for n, _ in tr["device_ops"]] == ["k1", "k2"]


def test_seg_readers():
    raw = {"unit": "seg_block", "setup_s": 12.0, "window_s": 30.0, "blocks": 20,
           "voxels_per_block": 512**3, "peak_reserved_window": 512**3 * 80,
           "phases": [{"1-forward": 1.0, "2-cc": 0.1, "3-assign": 0.2}] * 2,
           "cc_rounds": [3, 4], "model": MODEL, "tile": [256, 256, 96], "tiles_per_block": 24,
           "trace": None}
    assert read("seg_mvox_s", raw) == pytest.approx(20 * 512**3 / 30e6)
    assert read("seg_peak_B_per_vox", raw) == 80
    assert read("forward_s_per_block", raw) == 1.0
    assert read("cc_assign_s_per_block", raw) == pytest.approx(0.3)
    assert read("cc_rounds_per_block", raw) == 3.5
    assert read("train_step_ms", raw) is None
    # no trace: the trace's readers find nothing and return nothing
    assert read("kernel_roofline_pct.seg", raw) is None
    assert read("idle_pct.seg", raw) is None and read("seg_mfu_pct", raw) is None
    raw["trace"] = {"busy_s": 24.0, "window_s": 30.0, "kernels": {
        "void dwconv3d_tc_kernel<7>(x)": 20 * 0.02, "tail_tc_kernel<32>": 0.0}}
    assert read("idle_pct.seg", raw) == pytest.approx(20.0)
    assert read("seg_mfu_pct", raw) == pytest.approx(
        100 * 258680 * 512**3 * 20 / (30 * 989e12))
    least = 20 * sum(harness.bound_s(*w) for w in
                     harness.load_module("kernels", "dwconv").work(MODEL, raw))
    assert read("kernel_roofline_pct.seg", raw) == pytest.approx(100 * least / 0.4)
    assert read("kernel_roofline_pct.train", raw) is None
    # a kernel of no listed family (one a later family file may claim) leaves it as it was
    raw["trace"]["kernels"]["void propagate_kernel(x)"] = 5.0
    assert read("kernel_roofline_pct.seg", raw) == pytest.approx(100 * least / 0.4)


@pytest.mark.parametrize("metric", ["kernel_roofline_pct.seg", "kernel_roofline_pct.train"])
def test_roofline_metrics_name_their_families(metric):
    fams = harness.load_module("metrics", metric).FAMILIES
    assert fams == ("dwconv", "dwconv_wgrad", "tail", "ln_head", "upsample")
    assert set(fams) <= set(harness.names("kernels", ".py"))


def test_train_readers():
    raw = {"unit": "train_step", "setup_s": 20.0, "window_s": 30.0, "steps": 200,
           "intervals_ms": [150.0] * 190 + [300.0] * 10, "augment_ms": [10.0, 20.0],
           "peak_reserved_window": 1, "model": MODEL, "crop": [300, 300, 20], "batch": 1,
           "trace": None}
    assert read("train_step_ms", raw) == 150.0
    assert 150.0 <= read("train_step_p95_ms", raw) <= 300.0
    assert read("augment_ms_per_step", raw) == 15.0
    assert read("seg_mvox_s", raw) is None and read("setup_s", raw) == 20.0
