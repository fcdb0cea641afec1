"""Model FLOPs and the kernel families' work against hand counts."""

import json

import pytest

from benchmark import flops, harness

TINY = {"ARCHITECTURE": "bism_unext", "IN_CHANNELS": 1, "OUT_CHANNELS": 4, "DIMS": [8, 16, 8],
        "DEPTHS": [1, 1, 1], "KERNEL_SIZE": 3, "ACTIVATION": "gelu", "DTYPE": "bfloat16"}


def test_unext_flops_by_hand():
    # stem 2*27*8; block C=8: 2*27*8 + 16*64 (x2, encoder and decoder);
    # down 2*8*8*16/8; bottleneck (2*27*16 + 16*256)/8; concat 2*(16+8)*8;
    # final 2*8*4; heads 2*4*5
    hand = 432 + 1456 + 256 + 620 + 384 + 1456 + 64 + 40
    assert flops.forward_flops_per_voxel(TINY) == hand


def test_unet_flops_by_hand():
    m = dict(TINY, ARCHITECTURE="bism_unet")
    # conv 1->8 at 1; 8->16 at 1/8; (16+8)->8 at 1; head 2*8*4; heads 2*4*5
    hand = 2 * 27 * 8 + 2 * 27 * 8 * 16 / 8 + 2 * 27 * 24 * 8 + 64 + 40
    assert flops.forward_flops_per_voxel(m) == hand


def test_default_models():
    cfgs = {c: json.load(open(harness.BENCH / "configs" / f"{c}.json"))["cfg"]["MODEL"]
            for c in ("skoots_unext", "skoots_unet")}
    assert flops.forward_flops_per_voxel(cfgs["skoots_unext"]) == 258680
    assert flops.forward_flops_per_voxel(cfgs["skoots_unet"]) == 453376


def test_kernel_work_matches_the_port_table():
    """The bounds of the port's kernel table (PERF.md, PR 4 and PR 7 rows):
    dwconv C = 32 on a 256x256x96 tile 0.240 ms (bytes), the stem 0.140 ms
    (operations), the LN head 0.240 ms, the upsample [1,64,64,24,128]
    0.068 ms. The tail at 6,291,456 x 32 is held to the arithmetic its
    function needs (34 C FP32 FLOPs a voxel, 0.102 ms; the two matmuls
    0.104 ms), so its bytes bound it: 0.361 ms, where the table's 0.475 ms
    counts the port's epilogue instructions."""
    m = json.load(open(harness.BENCH / "configs" / "skoots_unext.json"))["cfg"]["MODEL"]
    raw = {"unit": "seg_block", "tile": [256, 256, 96], "tiles_per_block": 1}
    fam = {n: harness.load_module("kernels", n) for n in harness.names("kernels", ".py")}
    dw = [harness.bound_s(*w) * 1e3 for w in fam["dwconv"].work(m, raw)]
    assert len(dw) == 11
    assert dw[0] == pytest.approx(0.1396, abs=1e-3)
    assert dw[1] == pytest.approx(0.2404, abs=1e-3)
    tail = [harness.bound_s(*w) * 1e3 for w in fam["tail"].work(m, raw)]
    assert len(tail) == 10 and tail[0] == pytest.approx(0.3606, abs=1e-3)
    v = 256 * 256 * 96
    assert fam["tail"].work(m, raw)[0][1] == 34 * 32 * v
    head = [harness.bound_s(*w) * 1e3 for w in fam["ln_head"].work(m, raw)]
    assert head == [pytest.approx(0.2404, abs=1e-3)]
    up = [harness.bound_s(*w) * 1e3 for w in fam["upsample"].work(m, raw)]
    assert up[0] == pytest.approx(0.0676, abs=1e-3)
    assert fam["dwconv_wgrad"].work(m, raw) == []
    train = {"unit": "train_step", "crop": [96, 96, 32], "batch": 1}
    assert len(fam["dwconv"].work(m, train)) == 21  # 11 forward, 10 input gradients
    assert len(fam["dwconv_wgrad"].work(m, train)) == 11
    unet = dict(m, ARCHITECTURE="bism_unet")
    assert fam["dwconv"].work(unet, train) == [] and fam["tail"].work(unet, train) == []
    assert len(fam["upsample"].work(unet, train)) == 2
