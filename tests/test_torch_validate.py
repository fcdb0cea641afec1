"""The port's ``skoots-validate`` (``skoots_tpu_torch.validate``) against the
JAX package's, on the CPU.

* Every metric on seeded label volumes with non-sequential ids, touching
  instances, and empty volumes: counts, IoU, Dice, bounding boxes, box IoU,
  the error rates, (TP, FP, FN) and F1 exactly equal; clDice within 1e-5
  (both compute it in f32 on binary crops).
* ``stats.py``: the numpy functions equal, the parameter count of the same
  checkpoint equal, and ``get_flops`` (torch's FLOP counter) equal to the
  terms of ``analytic_unext_flops`` that it can see.
* Both CLIs on the same ``.npy`` pair: the two CSV reports equal line for
  line apart from the two path lines, and the same printed summary; the
  device rule and the plots' matplotlib requirement.
"""

import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import save_checkpoint
from skoots_tpu.validate import metrics as jm
from skoots_tpu.validate import stats as js
from skoots_tpu.validate.cli import main as jax_validate
from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.validate import metrics as tm
from skoots_tpu_torch.validate import stats as ts
from skoots_tpu_torch.validate.cli import main as torch_validate

SHAPE = (24, 20, 12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work is thousands of small CPU ops; under the
    suite's parallel workers each op's thread pool waits on the others'
    (the module ran 15x slower than alone), so it runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _boxes(rng, n, shape=SHAPE, ids=None):
    """A label volume of ``n`` random boxes with random (non-sequential)
    ids; later boxes overwrite earlier ones."""
    v = np.zeros(shape, np.int64)
    for k in range(n):
        lo = rng.integers(0, [s - 3 for s in shape])
        hi = lo + rng.integers(2, 9, 3)
        v[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = (
            ids[k] if ids is not None else rng.integers(1, 200))
    return v


def _case(name):
    """(gt, pred) label volumes of one named case."""
    rng = np.random.default_rng(7)
    if name == "random":
        gt = _boxes(rng, 10)
        pred = gt.copy()
        pred[pred == pred.max()] = 0  # a missed instance
        pred[3:9, 3:9, 2:6] = 311  # a merged / spurious one
        shift = _boxes(rng, 4, ids=[501, 502, 503, 504])
        pred = np.where(shift > 0, shift, pred)
        return gt, pred
    if name == "touching":
        gt = np.zeros(SHAPE, np.int64)
        gt[2:10, 2:18, 2:10] = 40
        gt[10:18, 2:18, 2:10] = 7  # shares a face with 40
        gt[18:22, 5:9, 1:11] = 1000
        pred = np.zeros(SHAPE, np.int64)
        pred[2:14, 2:18, 2:10] = 3  # over 40 and into 7
        pred[14:18, 2:18, 2:10] = 9
        pred[19:22, 5:9, 1:11] = 12
        return gt, pred
    gt = _boxes(rng, 6)
    empty = np.zeros(SHAPE, np.int64)
    if name == "empty_pred":
        return gt, empty
    if name == "empty_gt":
        return empty, gt
    return empty, empty.copy()


CASES = ["random", "touching", "empty_pred", "empty_gt", "both_empty"]


@pytest.mark.parametrize("name", CASES)
def test_metrics_match_jax(name):
    gt, pred = _case(name)
    want = jm.contingency(gt, pred)
    got = tm.contingency(gt, pred, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    for fn in ("mask_iou", "mask_dice"):
        w = getattr(jm, fn)(gt, pred)
        g = getattr(tm, fn)(gt, pred, device="cpu").numpy()
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape, fn
        np.testing.assert_array_equal(g, w)
    w = jm.mask_soft_cldice(gt, pred)
    g = tm.mask_soft_cldice(gt, pred, device="cpu").numpy()
    assert g.dtype == np.float32 and g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    assert tm.get_segmentation_errors(gt, pred, device="cpu") == \
        jm.get_segmentation_errors(gt, pred)
    iou = jm.mask_iou(gt, pred)
    for thr in (0.0, 0.1, 0.2, 0.5, 0.99):
        acc = tm.accuracies_from_iou(torch.from_numpy(iou), thr)
        assert acc == jm.accuracies_from_iou(iou, thr), thr
        assert tm.f1_score(*acc) == jm.f1_score(*acc)
    for vol in (gt, pred):
        want_bb = jm.mask_to_bbox(vol)
        got_bb = tm.mask_to_bbox(vol, device="cpu")
        assert sorted(got_bb) == sorted(want_bb)
        for k, v in want_bb.items():
            np.testing.assert_array_equal(got_bb[k].numpy(), v)


def test_touching_case_is_not_trivial():
    """The touching case exercises what it names: a prediction over two
    instances (an under-segmentation) and clDice on several pairs."""
    gt, pred = _case("touching")
    _, under = jm.get_segmentation_errors(gt, pred)
    assert under > 0
    assert (jm.mask_soft_cldice(gt, pred) > 0).sum() >= 3


def test_box_iou_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 10, (6, 6)).astype(np.float64)
    a[:, 3:] += a[:, :3] + rng.integers(0, 4, (6, 3))  # some zero-volume boxes
    b = rng.integers(0, 10, (5, 6)).astype(np.float64) + 0.25
    b[:, 3:] += b[:, :3] + 1.5
    for x, y in ((a, b), (a, a), (b, a[:0])):
        np.testing.assert_array_equal(tm.box_iou(x, y, device="cpu").numpy(),
                                      jm.box_iou(x, y))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """(checkpoint path, JAX params) of a tiny f32 UNeXT."""
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 16, 8, 4], [1, 2, 1, 1, 1]
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 4, 3
    cfg.MODEL.DTYPE = "float32"
    cfg.freeze()
    _, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    path = str(tmp_path_factory.mktemp("validate") / "tiny.skoots")
    save_checkpoint(path, cfg, params)
    return path, params


def test_stats_match_jax(tiny_ckpt):
    gt, pred = _case("random")
    for vol in (gt, pred, np.zeros(SHAPE, np.int64)):
        assert ts.get_volume(vol) == js.get_volume(vol)
        assert ts.get_surface_area(vol) == js.get_surface_area(vol)
        assert ts.stats_per_instance(vol) == js.stats_per_instance(vol)
    path, params = tiny_ckpt
    model = model_from_checkpoint(load_checkpoint(path), device="cpu")
    assert ts.get_parameter_count(model) == js.get_parameter_count(params)
    args = ([32, 64, 128, 64, 32], [2, 2, 2, 2, 2], 7, 32, 256 * 256 * 96)
    assert ts.analytic_unext_flops(*args) == js.analytic_unext_flops(*args)


def test_get_flops_counts_the_unext_products(tiny_ckpt):
    """``get_flops`` of the tiny UNeXT's backbone equals
    ``analytic_unext_flops`` less the terms torch's counter does not see:
    the elementwise ones (LayerNorms, GELU, layer scale, the upsample). The
    final 1x1 head is counted: at its width 4, which JAX's fused-head rule
    refuses, it runs flax's LayerNorm and 1x1 conv as a matmul (the fused
    head's plain version would add its products elementwise,
    ``kernels/lnhead.py::ln_head_ref``)."""
    path, _ = tiny_ckpt
    model = model_from_checkpoint(load_checkpoint(path), device="cpu")
    dims, depths, k, out_ch = [4, 8, 16, 8, 4], [1, 2, 1, 1, 1], 3, 4
    tile = (16, 16, 8)
    vox_n = int(np.prod(tile))
    got = ts.get_flops(model.backbone, torch.zeros((1, *tile, 1)))
    n_down = len(dims) // 2
    vox = [vox_n // 8 ** lvl for lvl in range(n_down + 1)]
    levels = [0, 1, 2, 1, 0]  # each stage's resolution level
    non_products = sum(d * (10 + 8 * 4 + 3) * vox[lvl] * c  # LN, GELU, tail
                       for d, lvl, c in zip(depths, levels, dims))
    non_products += sum(10 * vox[s] * dims[s] for s in range(n_down))
    non_products += sum(9 * vox[n_down - 1 - s] * dims[n_down + s]
                        for s in range(n_down))
    non_products += 10 * vox[0] * dims[-1]
    want = ts.analytic_unext_flops(dims, depths, k, out_ch, vox_n) - non_products
    assert got == want, (got, want)


def _csvs(stem):
    out = {}
    for name in ("accuracy_stats", "intersection_over_union"):
        with open(f"{stem}_{name}.csv") as f:
            out[name] = f.read().splitlines()
    return out


def test_cli_writes_the_jax_reports(tmp_path, capsys):
    """``skoots-validate`` and ``skoots-validate-torch --device cpu`` on the
    same ``.npy`` pair (margin cropped): both CSV reports equal line for
    line apart from the two path lines, and the same printed summary."""
    gt, pred = _case("random")
    stems = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        np.save(d / "gt.npy", gt)
        np.save(d / "pred.npy", pred)
        stems[side] = str(d / "pred")
    args = {side: ["-g", stems[side][:-4] + "gt.npy", "-p", stems[side] + ".npy",
                   "--margin", "2", "2", "1", "--no-plots"] for side in stems}
    capsys.readouterr()
    assert jax_validate(args["jax"]) == 0
    printed_jax = capsys.readouterr().out
    assert torch_validate(args["torch"] + ["--device", "cpu"]) == 0
    printed_torch = capsys.readouterr().out
    assert printed_torch == printed_jax and "F1@0.5" in printed_jax
    want, got = _csvs(stems["jax"]), _csvs(stems["torch"])
    for name in want:
        assert len(got[name]) == len(want[name]) > 2, name
        assert got[name][0].startswith("Ground Truth File: ")
        assert got[name][1].startswith("Predicted File: ")
        assert got[name][2:] == want[name][2:], name
    assert len(want["intersection_over_union"]) == 6 + len(np.unique(gt[2:-2, 2:-2, 1:-1])) - 1


def test_cli_writes_plots(tmp_path):
    gt, pred = _case("touching")
    np.save(tmp_path / "gt.npy", gt)
    np.save(tmp_path / "pred.npy", pred)
    assert torch_validate(["-g", str(tmp_path / "gt.npy"), "-p",
                           str(tmp_path / "pred.npy"), "--no-cldice",
                           "--device", "cpu"]) == 0
    for name in ("precision", "recall", "f1"):
        assert os.path.getsize(tmp_path / f"pred_{name}.png") > 0


def test_cli_plots_without_matplotlib_raise(tmp_path, monkeypatch):
    """Where matplotlib is missing, asking for the plots raises an
    ImportError that names --no-plots; it never skips them silently."""
    gt, pred = _case("touching")
    np.save(tmp_path / "gt.npy", gt)
    np.save(tmp_path / "pred.npy", pred)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--no-plots"):
        torch_validate(["-g", str(tmp_path / "gt.npy"), "-p",
                        str(tmp_path / "pred.npy"), "--device", "cpu"])


def test_cli_without_cuda_raises(tmp_path):
    """The CLI runs on the card by default; without one it raises unless
    --device cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI would run on it")
    gt, pred = _case("touching")
    np.save(tmp_path / "gt.npy", gt)
    shutil.copy(tmp_path / "gt.npy", tmp_path / "pred.npy")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_validate(["-g", str(tmp_path / "gt.npy"), "-p",
                        str(tmp_path / "pred.npy"), "--no-plots"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.mask_iou(gt, pred)
    assert not os.path.exists(tmp_path / "pred_accuracy_stats.csv")
