"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU (the program's plain versions) at a size a test run holds: the
cell's entry, its window, and the comparison with the reference at the
cell's own limits. The faults: an answer altered where it is produced (the
instance mask split), the CC's labels altered where they are produced, a
training step that leaves the state unchanged or steps against the gradient
(its sign flipped: the norms alone would not see it), and the control (the fp8
reference in the program's place). Training at batch 1 has no half batch to
leave out, and one card no exchange between cards. A sound segmentation
run at this size reads a larger foreground mismatch than the cell's limit,
which is set at the cell's 512^3 size (more foreground, fewer tile edges a
voxel), so its sound runs are shown on the card only; the training sound
runs hold here.
"""

import copy
import time

import pytest
import torch

from benchmark import harness


def _seg(fault=None, control=False, seed=2**35 + 11):
    torch.set_num_threads(4)
    name = "unext_seg_tubes512"
    ctx = harness.Context(name, harness.load_json("workloads", name), seed, 0.0, False,
                          torch.device("cpu"), time.perf_counter())
    ctx.mix = dict(ctx.mix, shape=[128, 128, 48], blocks=2, tubes=10)
    ctx.workload = dict(ctx.workload, warmup=1,
                        pipeline=dict(ctx.workload["pipeline"], crop=[32, 32, 16]))
    ctx.fault, ctx.control = fault, control
    return harness.load_module("entries", "seg_blocks").run(ctx)


def _train(name, fault=None, control=False, seed=2**36 + 5):
    torch.set_num_threads(4)
    ctx = harness.Context(name, harness.load_json("workloads", name), seed, 0.0, False,
                          torch.device("cpu"), time.perf_counter())
    ctx.mix = dict(ctx.mix, shape=[160, 160, 32], volumes=2, tubes=8)
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["cfg"]["AUGMENTATION"].update(CROP_WIDTH=64, CROP_HEIGHT=64, CROP_DEPTH=16)
    ctx.workload = dict(ctx.workload, warmup=1)
    ctx.fault, ctx.control = fault, control
    return harness.load_module("entries", "train_steps").run(ctx)


@pytest.mark.parametrize("fault", ["answer", "cc"])
def test_seg_fault_is_not_correct(fault):
    assert not _seg(fault=fault)["correct"]


def test_seg_control_is_not_correct():
    out = _seg(control=True)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", ["unext_train_300", "unet_train_300"])
def test_train_sound_run_is_correct(cell):
    out = _train(cell)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("cell", ["unext_train_300", "unet_train_300"])
def test_train_unchanged_state_is_not_correct(cell):
    out = _train(cell, fault="unchanged")
    assert not out["correct"]
    assert out["compared"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["unext_train_300", "unet_train_300"])
def test_train_flipped_gradient_is_not_correct(cell):
    out = _train(cell, fault="flipped")
    assert not out["correct"]
    assert out["compared"]["grad_diff"]["value"] > 1.5
    assert out["compared"]["grad_gap"]["value"] <= out["compared"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", ["unext_train_300", "unet_train_300"])
def test_train_control_is_not_correct(cell):
    out = _train(cell, control=True)
    assert not out["correct"], out["compared"]
