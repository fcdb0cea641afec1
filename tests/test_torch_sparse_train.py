"""Sparse training's loop against the JAX package on the CPU: SWA's
running mean in the checkpoint, the threshold calibrator, and
``skoots-train-torch`` with ``EXPERIMENTAL.IS_SPARSE`` end to end (the
pieces and the step are in tests/test_torch_sparse.py)."""

import glob
import logging
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy import ndimage

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.experimental import data as JXD
from skoots_tpu.experimental import sparse_engine as JXE
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from skoots_tpu.train.checkpoint import restore_params
from skoots_tpu.train.engine import TrainState as JaxTrainState
from skoots_tpu.train.generate_skeletons import save_skeletons as jax_save_skeletons
from skoots_tpu.utils.io import imsave
from skoots_tpu.utils.synthetic import make_tubes as jax_make_tubes
from skoots_tpu_torch import config as C
from skoots_tpu_torch.checkpoint import (
    flax_params_from_torch,
    load_checkpoint,
    torch_params_from_flax,
)
from skoots_tpu_torch.experimental import data as XD
from skoots_tpu_torch.experimental import sparse_engine as XE
from skoots_tpu_torch.models import cfg_to_model, load_flax_params, model_from_checkpoint

T = torch.from_numpy

TINY_MODEL = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
              "KERNEL_SIZE": 3, "DTYPE": "float32"}
TINY = {"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
        "TRAIN": {"LOSS_SKELETON_START_EPOCH": -1, "MAX_SKELETON_POINTS": 64},
        "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8},
        "EXPERIMENTAL": {"IS_SPARSE": True, "DIST_THR": 5.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small CPU ops: on one thread, so the suite's parallel
    workers do not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both_cfgs(update):
    jc = jax_defaults()
    jc.merge_from_dict(update)
    return jc, C.merge_from_dict(C.get_cfg_defaults(), update)


def _merge(*updates):
    out: dict = {}
    for u in updates:
        for sec, vals in u.items():
            out.setdefault(sec, {}).update(vals)
    return out


@pytest.fixture(scope="module")
def sparse_dir(tmp_path_factory):
    """Two sparse volumes: images, certain background (> 6 voxels from a
    tube) and skeleton points."""
    d = tmp_path_factory.mktemp("sparse_data")
    for i in range(2):
        img, labels, skels = jax_make_tubes(shape=(64, 64, 8), n_tubes=2, seed=i)
        imsave(str(d / f"v{i}.tif"), img)
        imsave(str(d / f"v{i}.background.tif"),
               (ndimage.distance_transform_edt(labels == 0) > 6).astype(np.uint8))
        jax_save_skeletons(str(d / f"v{i}.skeletons.npz"), skels)
    return str(d)


def _tiny_models():
    jc, tc = _both_cfgs(TINY)
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    return jc, tc, jmodel, jax.tree_util.tree_map(np.asarray, jparams)


def _weights_of_epoch(tree, e):
    """Seeded weights for epoch ``e`` in the shape of a flax tree, the same
    in both packages (each leaf seeded by its path)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    vals = [np.random.default_rng([e, zlib.crc32(jax.tree_util.keystr(p).encode())])
            .standard_normal(np.shape(v)).astype(np.float32) for p, v in flat]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree), vals)


def test_swa_and_calibrator_match_jax(sparse_dir, tmp_path, monkeypatch):
    """``train_sparse`` for 16 epochs in both packages, each step replaced
    by one that sets the weights of its epoch: the checkpoint holds SWA's
    running mean over the last 4 epochs (from int(0.75 * 16) = 12 on),
    equal to JAX's, and the calibrated thresholds agree within 1e-5."""
    cfg = _merge(TINY, {"TRAIN": {"TRAIN_DATA_DIR": [sparse_dir], "TRAIN_SAMPLE_PER_IMAGE": [1],
                                  "NUM_EPOCHS": 16, "SAVE_INTERVAL": 100}})
    saved = {}
    for pkg in ("jax", "torch"):
        cfg["TRAIN"]["SAVE_PATH"] = str(tmp_path / pkg)
        jc, tc = _both_cfgs(cfg)
        if pkg == "jax":
            def fake_jax(model, optimizer, schedule, sigma, c):
                def step(state, batch, epoch):
                    return (JaxTrainState(step=state.step + 1, params=jax.tree_util.tree_map(
                        jnp.asarray, _weights_of_epoch(state.params, int(epoch))),
                        opt_state=state.opt_state), {"loss": jnp.zeros(())})
                return step
            monkeypatch.setattr(JXE, "make_sparse_train_step", fake_jax)
            JXE.train_sparse(jc, steps_per_epoch=1)
        else:
            def fake_torch(model, optimizer, schedule, sigma, c):
                def step(batch, epoch):
                    tree = flax_params_from_torch(model.state_dict())
                    model.load_state_dict(torch_params_from_flax(_weights_of_epoch(tree, epoch)))
                    return {"loss": 0.0}
                return step
            monkeypatch.setattr(XE, "make_sparse_train_step", fake_torch)
            state = XE.train_sparse(tc, steps_per_epoch=1, device="cpu")
            assert state.step == 16
        (path,) = glob.glob(str(tmp_path / pkg / "*_sparse.skoots"))
        saved[pkg] = jax_load_checkpoint(path)
    for ck in saved.values():
        assert ck["extra"]["epoch"] == 15 and ck["extra"]["swa"] is True
    jflat = jax.tree_util.tree_flatten_with_path(saved["jax"]["params"])[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(saved["torch"]["params"])[0])
    assert len(jflat) == len(tflat)
    mean = np.mean([jax.tree_util.tree_leaves(_weights_of_epoch(saved["jax"]["params"], e))[0]
                    for e in range(12, 16)], axis=0)
    np.testing.assert_allclose(jflat[0][1], mean, rtol=1e-5, atol=1e-6)
    for p, v in jflat:
        np.testing.assert_array_equal(tflat[p], v, err_msg=str(p))
    j_thr = saved["jax"]["extra"]["calibrated_prob_threshold"]
    t_thr = saved["torch"]["extra"]["calibrated_prob_threshold"]
    assert j_thr is not None and abs(t_thr - j_thr) <= 1e-5, (t_thr, j_thr)


def test_threshold_calibrator_matches_jax(sparse_dir):
    """The same f32 weights and dataset: the calibrated threshold within
    1e-5 of JAX's, from the same 8 centred windows; the forwards counted."""
    jc, tc, jmodel, jparams = _tiny_models()
    jc.merge_from_dict({"EXPERIMENTAL": {"DIST_THR": 2.0}})
    tc["EXPERIMENTAL"]["DIST_THR"] = 2.0
    jd, td = JXD.SparseDataset(sparse_dir, jc), XD.SparseDataset(sparse_dir, tc)
    want = JXE.make_threshold_calibrator(jmodel, jc, jd, 40.0, 20.0)(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    calibrate = XE.make_threshold_calibrator(tc, td, 40.0, 20.0)
    got = calibrate(load_flax_params(cfg_to_model(tc), jparams))
    assert want is not None and abs(got - want) <= 1e-5, (got, want)
    assert calibrate.forwards == 8


def test_sparse_cli_end_to_end(sparse_dir, tmp_path, monkeypatch, caplog):
    """``skoots-train-torch`` with ``EXPERIMENTAL.IS_SPARSE`` on the CPU,
    2 epochs x 2 steps (as tests/test_sparse.py's JAX run): one
    ``*_sparse.skoots`` whose calibrated threshold lies in [0.5, 0.9999],
    loaded by both packages with equal f32 forwards, and whose optimizer
    state JAX's ``restore_params`` reads (4 updates)."""
    from skoots_tpu.models import init_model as jinit
    from skoots_tpu_torch.train.cli import main

    monkeypatch.chdir(tmp_path)
    save_dir = tmp_path / "models"
    cfg = _merge(TINY, {"TRAIN": {"TRAIN_DATA_DIR": [sparse_dir], "TRAIN_SAMPLE_PER_IMAGE": [1],
                                  "NUM_EPOCHS": 2, "SAVE_INTERVAL": 2,
                                  "SAVE_PATH": str(save_dir)}})
    p = tmp_path / "sparse.yaml"
    p.write_text(yaml.safe_dump(cfg))
    with caplog.at_level(logging.INFO, logger="skoots_tpu_torch.experimental.sparse_engine"):
        assert main(["--config-file", str(p), "--steps-per-epoch", "2", "--log", "1",
                     "--device", "cpu"]) == 0
    assert sum(r.msg.startswith("sparse epoch %d") for r in caplog.records) == 2
    ckpts = glob.glob(os.path.join(str(save_dir), "*_sparse.skoots"))
    assert len(ckpts) == 1
    extra = load_checkpoint(ckpts[0])["extra"]
    cal = extra["calibrated_prob_threshold"]
    assert cal is not None and 0.5 <= cal <= 0.9999
    assert extra["epoch"] == 1 and extra["swa"] is True

    tm = model_from_checkpoint(load_checkpoint(ckpts[0]))
    ck = jax_load_checkpoint(ckpts[0])
    assert ck["extra"]["calibrated_prob_threshold"] == cal
    jmodel, tmpl = jinit(ck["cfg"], jax.random.PRNGKey(0), spatial=(16, 16, 8))
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 8, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(restore_params(tmpl, ck["params"]), jnp.asarray(x),
                                   deterministic=True))
    np.testing.assert_allclose(tm(T(x)).detach().numpy(), want, atol=2e-5, rtol=0)
    # the optimizer state, saved as JAX's sparse loop saves it: 4 updates
    from skoots_tpu.train.engine import cfg_optimizer as jax_cfg_optimizer

    opt_state = restore_params(jax_cfg_optimizer(ck["cfg"])[0].init(tmpl), ck["opt_state"])
    assert int(opt_state.count) == 4
