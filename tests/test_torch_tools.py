"""The port's last four user tools (``skoots_tpu_torch/tools/``) against
the JAX repo's (``tools/``, imported by path) on the CPU, each at the
smallest size that runs its path:

* ``skeleton_quality``: the rows of every shape (medial and TEASAR at the
  tool's sizes; Lee on a 32x32x16 blob) equal the JAX tool's within 1e-6,
  the masks and point counts exactly; ``main`` writes JAX's row keys.
* ``convergence``: the phantoms equal the JAX tool's (one training volume
  and the validation one), the cfg the port writes reads back through
  JAX's loader as the cfg JAX's ``write_cfg`` writes, and a 1 epoch x 1
  step CPU run writes ``result.json`` with JAX's keys.
* ``score_checkpoint``: the scores equal the JAX tool's arithmetic on JAX's
  ``validate.metrics`` for the same GT and prediction (exact).
* ``calibrate_sparse_ckpt``: on a tiny f32 sparse checkpoint, the port's
  tool and the JAX tool each rewrite a copy; JAX's ``load_checkpoint`` of
  both gives bit-equal parameters, the same optimizer state, cfg,
  statistics and other ``extra`` keys, and thresholds within 1e-5 of each
  other (as ``tests/test_torch_sparse_train.py`` holds the calibrators);
  with no skeleton point in reach, both exit 1 and leave the file alone.

Torch runs on one thread (the suite's parallel workers share the cores).
"""

import importlib.util
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from skoots_tpu import config as JC
from skoots_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from skoots_tpu.train.generate_skeletons import calculate_skeletons as jax_skeletons
from skoots_tpu.train.generate_skeletons import load_skeletons as jax_load_skeletons
from skoots_tpu.utils.io import imread as jax_imread
from skoots_tpu.validate.metrics import accuracies_from_iou as jax_accuracies
from skoots_tpu.validate.metrics import mask_iou as jax_mask_iou
from skoots_tpu_torch.tools import calibrate_sparse_ckpt as tcal
from skoots_tpu_torch.tools import convergence as tconv
from skoots_tpu_torch.tools import score_checkpoint as tscore
from skoots_tpu_torch.tools import skeleton_quality as tsq

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- skeleton_quality -------------------------------------------------------

def _rows_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    assert got["n_points"] == want["n_points"]
    for k in ("coverage", "centered", "inside"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)


@pytest.mark.parametrize("shape", sorted(tsq.SHAPES))
def test_skeleton_quality_rows_match_jax(shape):
    jsq = _jax_tool("skeleton_quality")
    mask = tsq.SHAPES[shape]()
    np.testing.assert_array_equal(mask, jsq.SHAPES[shape]())
    rows = tsq.quality_rows({shape: mask}, methods=("medial", "teasar"))[shape]
    for method, got in rows.items():
        want = jsq.score_skeleton(mask, jax_skeletons(mask, scale=(1.0, 1.0, 3.0),
                                                      method=method)[1])
        _rows_close(got, want)
        assert 0.0 < got["coverage"] <= 1.0 and got["n_points"] > 0


def test_skeleton_quality_lee_and_main_match_jax(tmp_path, monkeypatch):
    """Lee thinning on a blob small enough for JAX's Python fallback, and
    ``main``'s file: JAX's row keys for every method."""
    jsq = _jax_tool("skeleton_quality")
    mask = tsq.irregular_blob((32, 32, 16))
    np.testing.assert_array_equal(mask, jsq.irregular_blob((32, 32, 16)))
    got = tsq.quality_rows({"blob": mask}, methods=("lee",))["blob"]["lee"]
    _rows_close(got, jsq.score_skeleton(mask, jax_skeletons(mask, scale=(1.0, 1.0, 3.0),
                                                            method="lee")[1]))
    monkeypatch.setattr(tsq, "SHAPES", {"blob": lambda: mask})
    out = tmp_path / "sq.json"
    assert tsq.main(["--out", str(out)]) == 0
    import json

    rows = json.loads(out.read_text())
    assert list(rows) == ["blob"] and list(rows["blob"]) == list(tsq.METHODS)
    for method, r in rows["blob"].items():
        assert set(r) == {"coverage", "centered", "inside", "n_points"}, method
    assert rows["blob"]["lee"] == got


# -- convergence ------------------------------------------------------------

JAX_CONVERGENCE_KEYS = {"ok", "f1_at_iou50", "mean_iou", "tp", "fp", "fn", "gt_instances",
                        "pred_instances", "train_s", "infer_s", "epochs", "checkpoint"}


@pytest.fixture(scope="module")
def convergence_run(tmp_path_factory):
    """(exit code, outdir) of one epoch of one step on the CPU through the
    real CLIs (TensorBoard off: its import alone takes longer than the
    step)."""
    from skoots_tpu_torch.train import cli

    root = tmp_path_factory.mktemp("convergence")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(cli, "summary_writer", lambda *a, **k: None)
        out = root / "conv"
        rc = tconv.main(["--epochs", "1", "--steps-per-epoch", "1", "--device", "cpu",
                         "--outdir", str(out)])
    return rc, out


def test_convergence_dataset_matches_jax(convergence_run, tmp_path):
    """The run's phantoms against JAX's ``build_dataset`` (one training
    volume and the validation one)."""
    _, out = convergence_run
    jtrain, jval = _jax_tool("convergence").build_dataset(str(tmp_path), n_train=1)
    for jdir, tdir, names in ((jtrain, out / "train", ("vol0.tif", "vol0.labels.tif")),
                              (jval, out / "val", ("val.tif", "val.labels.tif"))):
        for n in names:
            want = np.asarray(jax_imread(os.path.join(jdir, n)))
            got = np.asarray(jax_imread(str(tdir / n)))
            assert got.dtype == want.dtype and got.any()
            np.testing.assert_array_equal(got, want)
    assert sorted(os.listdir(out / "train")) == [
        f"vol{i}{ext}" for i in range(3) for ext in (".labels.tif", ".skeletons.npz", ".tif")]
    want = jax_load_skeletons(os.path.join(jtrain, "vol0.skeletons.npz"))
    got = jax_load_skeletons(str(out / "train" / "vol0.skeletons.npz"))
    assert got.keys() == want.keys() and len(got) == 5
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("epochs", [1, 150])
def test_convergence_cfg_matches_jax(tmp_path, epochs):
    """JAX's loader reads the port-written cfg as the cfg JAX's
    ``write_cfg`` writes (PyYAML); the port's loader reads it the same."""
    jconv = _jax_tool("convergence")
    jconv.write_cfg(str(tmp_path / "j.yaml"), "/data/train", "/data/models", epochs)
    tconv.write_cfg(str(tmp_path / "t.yaml"), "/data/train", "/data/models", epochs)
    want = JC.load_cfg_from_file(str(tmp_path / "j.yaml")).to_dict()
    assert JC.load_cfg_from_file(str(tmp_path / "t.yaml")).to_dict() == want
    from skoots_tpu_torch.config import load_cfg_from_file

    assert load_cfg_from_file(str(tmp_path / "t.yaml")).to_dict() == want
    assert list(want["TRAIN"]["SIGMA_DECAY"][2]) == [0.5, int(epochs * 0.85)]


def test_convergence_cpu_run_writes_jax_keys(convergence_run):
    """A checkpoint written, the validation volume segmented by the host
    engine, ``result.json`` with JAX's keys and the exit code its ``ok``."""
    import json

    rc, out = convergence_run
    result = json.loads((out / "result.json").read_text())
    assert JAX_CONVERGENCE_KEYS <= set(result), JAX_CONVERGENCE_KEYS - set(result)
    assert rc == (0 if result["ok"] else 1)
    assert result["epochs"] == 1 and result["steps"] == 1 and result["device"] == "cpu"
    assert result["engine"] == "host" and result["gt_instances"] >= 4
    assert (out / result["checkpoint"]).is_file()


# -- score_checkpoint -------------------------------------------------------

def _jax_score(gt, pred):
    """The JAX tool's arithmetic, on JAX's metrics."""
    iou = jax_mask_iou(gt, pred)
    n_gt, n_pred = iou.shape
    best = iou.max(axis=1) if iou.size else np.zeros(n_gt)
    tp, fp, fn = jax_accuracies(iou, 0.5)
    f1 = 2 * tp / max(2 * tp + fp + fn, 1)
    return {
        "ok": bool(f1 >= 0.8 and (best.mean() if best.size else 0) >= 0.7),
        "f1_at_iou50": round(float(f1), 4),
        "mean_iou": round(float(best.mean()) if best.size else 0.0, 4),
        "tp": int(tp), "fp": int(fp), "fn": int(fn),
        "gt_instances": int(n_gt), "pred_instances": int(n_pred),
    }


def _labels(seed, shape=(40, 36, 12), n=6):
    rng = np.random.default_rng(seed)
    seeds = np.zeros(shape, np.int32)
    for i in range(1, n + 1):
        seeds[tuple(rng.integers(0, s) for s in shape)] = i
    lab = ndimage.grey_dilation(seeds, size=(9, 9, 5))
    return lab


@pytest.mark.parametrize("case", ["same", "shifted", "split", "empty"])
def test_score_matches_jax(case):
    gt = _labels(21)
    pred = {"same": gt, "shifted": np.roll(gt, 3, axis=0),
            "split": np.where((gt > 0) & (np.arange(gt.shape[1])[None, :, None] > 18),
                              gt + 10, gt),
            "empty": np.zeros_like(gt)}[case]
    assert tscore.score(gt, pred) == _jax_score(gt, pred)


# -- calibrate_sparse_ckpt ---------------------------------------------------

TINY = {"MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
                  "KERNEL_SIZE": 3, "DTYPE": "float32"},
        "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
        "TRAIN": {"LOSS_SKELETON_START_EPOCH": -1, "MAX_SKELETON_POINTS": 64},
        "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8},
        "EXPERIMENTAL": {"IS_SPARSE": True, "DIST_THR": 2.0}}


@pytest.fixture(scope="module")
def sparse_ckpt(tmp_path_factory):
    """(checkpoint, train dir, no-point train dir): a tiny f32 UNeXT with
    seeded random weights, an optax state with seeded moments and ``extra``
    without a threshold, saved by JAX; two sparse volumes (images, certain
    background, skeletons), and one volume without skeleton points."""
    from skoots_tpu.models import init_model
    from skoots_tpu.train.checkpoint import save_checkpoint
    from skoots_tpu.train.engine import cfg_optimizer
    from skoots_tpu.train.generate_skeletons import save_skeletons
    from skoots_tpu.utils.io import imsave
    from skoots_tpu.utils.synthetic import make_tubes

    d = tmp_path_factory.mktemp("calibrate")
    train, empty = d / "train", d / "empty"
    train.mkdir()
    empty.mkdir()
    for i in range(2):
        img, labels, skels = make_tubes(shape=(64, 64, 8), n_tubes=2, seed=i)
        bg = (ndimage.distance_transform_edt(labels == 0) > 6).astype(np.uint8)
        imsave(str(train / f"v{i}.tif"), img)
        imsave(str(train / f"v{i}.background.tif"), bg)
        save_skeletons(str(train / f"v{i}.skeletons.npz"), skels)
        if i == 0:
            imsave(str(empty / "v0.tif"), img)
            imsave(str(empty / "v0.background.tif"), bg)
            save_skeletons(str(empty / "v0.skeletons.npz"), {})
    cfg = JC.get_cfg_defaults()
    cfg.merge_from_dict(TINY)
    _, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3, jnp.float32), params)
    opt, _ = cfg_optimizer(cfg)
    # optax's state with seeded moments (an eager update takes seconds)
    state = jax.tree_util.tree_map(
        lambda v: v + jnp.asarray(rng.standard_normal(v.shape) * 1e-3, v.dtype)
        if v.ndim and jnp.issubdtype(v.dtype, jnp.floating) else v, opt.init(params))
    path = str(d / "old_sparse.skoots")
    save_checkpoint(path, cfg, params, state, dataset_mean=40.0, dataset_std=20.0,
                    extra={"epoch": 7, "swa": True, "note": "trained before calibration"})
    return path, str(train), str(empty)


def _run_jax_tool(monkeypatch, ckpt, train_dir) -> int:
    jcal = _jax_tool("calibrate_sparse_ckpt")
    monkeypatch.setenv("SKOOTS_COMPILE_CACHE", "off")
    monkeypatch.setattr(sys, "argv", ["calibrate_sparse_ckpt.py", ckpt, train_dir])
    return jcal.main()


def _same_tree(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(fa) == len(fb) and fa
    for p, v in fa:
        w = fb[p]
        assert np.asarray(v).dtype == np.asarray(w).dtype, p
        np.testing.assert_array_equal(np.asarray(w), np.asarray(v), err_msg=str(p))


def test_calibrate_sparse_ckpt_matches_jax(sparse_ckpt, tmp_path, monkeypatch):
    path, train_dir, _ = sparse_ckpt
    mine, theirs = str(tmp_path / "port.skoots"), str(tmp_path / "jax.skoots")
    shutil.copy(path, mine)
    shutil.copy(path, theirs)
    assert tcal.main([mine, train_dir, "--device", "cpu"]) == 0
    assert _run_jax_tool(monkeypatch, theirs, train_dir) == 0
    orig, got, want = (jax_load_checkpoint(p) for p in (path, mine, theirs))
    _same_tree(orig["params"], got["params"])
    _same_tree(orig["opt_state"], got["opt_state"])
    _same_tree(want["opt_state"], got["opt_state"])
    assert got["cfg"].to_dict() == orig["cfg"].to_dict()
    assert (got["dataset_mean"], got["dataset_std"]) == (40.0, 20.0)
    thr = got["extra"].pop("calibrated_prob_threshold")
    j_thr = want["extra"].pop("calibrated_prob_threshold")
    assert "calibrated_prob_threshold" not in orig["extra"]
    assert got["extra"] == want["extra"] == orig["extra"]
    assert isinstance(thr, float) and abs(thr - j_thr) <= 1e-5, (thr, j_thr)
    # the port reads its own file back: the same threshold and weights
    from skoots_tpu_torch.checkpoint import load_checkpoint

    ck = load_checkpoint(mine)
    assert ck["extra"]["calibrated_prob_threshold"] == thr
    _same_tree(orig["params"], ck["params"])


def test_calibrate_sparse_ckpt_without_points_exits_1(sparse_ckpt, tmp_path, monkeypatch):
    path, _, empty_dir = sparse_ckpt
    mine, theirs = str(tmp_path / "port.skoots"), str(tmp_path / "jax.skoots")
    shutil.copy(path, mine)
    shutil.copy(path, theirs)
    assert tcal.main([mine, empty_dir, "--device", "cpu"]) == 1
    assert _run_jax_tool(monkeypatch, theirs, empty_dir) == 1
    before = Path(path).read_bytes()
    assert Path(mine).read_bytes() == before == Path(theirs).read_bytes()
