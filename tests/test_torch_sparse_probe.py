"""The port's sparse-checkpoint semantic gate and ``--convert`` against the
JAX package's, on the CPU.

* ``calibrate_semantic_threshold_from_histogram`` on seeded probability
  sets (a ring mode below a saturation spike, no valley, one mode, too few
  values): exactly equal, ``None`` included.
* ``_probe_semantic_threshold`` on a tiny f32 checkpoint: the same
  threshold, or at least the same histogram bin (the two forwards sum in
  other orders).
* ``run_inference``'s order of resolution with a sparse checkpoint, in both
  packages: the probe, then the checkpoint's
  ``calibrated_prob_threshold``, then ``prob_threshold``.
* ``--convert`` in both packages on a vector field, a label volume and a
  probability volume: equal arrays read back.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.cli import main as jax_cli
from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.infer.autoknobs import (
    calibrate_semantic_threshold_from_histogram as jax_calibrate,
)
from skoots_tpu.infer.engine import _probe_semantic_threshold as jax_probe
from skoots_tpu.infer.engine import run_inference as jax_run
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import save_checkpoint
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.cli import main as torch_cli
from skoots_tpu_torch.infer.autoknobs import calibrate_semantic_threshold_from_histogram
from skoots_tpu_torch.infer.engine import (
    _probe_probabilities,
    _probe_semantic_threshold,
    run_inference,
)
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.utils.io import imread

KW = dict(crop_size=(32, 32, 8), overlap=(0, 0, 0), assign_crop_size=(32, 32, 8),
          assign_overlap=(0, 0, 0), dilation_3d=1, dilation_2d=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work is thousands of small CPU ops; under the
    suite's parallel workers each op's thread pool waits on the others'
    (the module ran 15x slower than alone), so it runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _probabilities(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    sig = lambda t: 1.0 / (1.0 + np.exp(-t))  # noqa: E731
    if kind == "ring_and_spike":  # a decaying ring mode, a valley, a spike
        ring = sig(rng.normal(1.0, 1.2, 40_000))
        spike = sig(rng.normal(9.0, 0.8, 15_000))
        bg = rng.uniform(0.0, 0.5, 30_000)
        return np.concatenate([ring, spike, bg]).astype(np.float32)
    if kind == "one_mode":
        return sig(rng.normal(3.0, 1.0, 20_000)).astype(np.float32)
    if kind == "saturated":  # most values clip to the same logit
        p = np.ones(5_000, np.float32)
        p[:100] = sig(rng.normal(4.0, 0.5, 100))
        return p
    if kind == "too_few":
        return np.concatenate([rng.uniform(0.0, 0.5, 10_000),
                               rng.uniform(0.5, 1.0, 999)]).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["ring_and_spike", "one_mode", "saturated", "too_few"])
def test_histogram_calibration_matches_jax(kind):
    probs = _probabilities(kind)
    want = jax_calibrate(probs)
    got = calibrate_semantic_threshold_from_histogram(probs)
    assert got == want
    assert (want is None) == (kind == "too_few")
    if kind == "ring_and_spike":  # the valley sits between the two modes
        assert 1.0 < _logit(want) < 9.0


def _cfg(sparse: bool):
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 16, 8, 4], [1, 1, 1, 1, 1]
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 4, 3
    cfg.MODEL.DTYPE = "float32"
    cfg.SKOOTS.VECTOR_SCALING = [4.0, 4.0, 2.0]
    cfg.EXPERIMENTAL.IS_SPARSE = sparse
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The u8 volume (64x64x8 tubes) and tiny f32 checkpoints of one random
    UNeXT: ``hot`` (sparse; its semantic head's bias raised by 2, so most
    probabilities exceed 0.5), ``hot_calibrated`` (the same with a
    recorded ``calibrated_prob_threshold``), ``cold_calibrated`` (the
    semantic bias lowered by 12: no foreground for the probe) and
    ``cold_sparse`` (the same without a recorded threshold); plus the JAX
    model and the hot parameters."""
    d = tmp_path_factory.mktemp("sparse")
    img, _, _ = make_tubes(shape=(64, 64, 8), n_tubes=2)
    model, params = init_model(_cfg(True), jax.random.PRNGKey(0), spatial=(16, 16, 8))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.5, jnp.float32), params)
    heads = params["params"]
    heads["vector_head"]["kernel"] = heads["vector_head"]["kernel"] * 0.1
    heads["vector_head"]["bias"] = heads["vector_head"]["bias"] * 0.0
    bias = heads["semantic_head"]["bias"]
    mean, std = float(img.mean()), float(img.std())
    out = {}
    for name, shift, sparse, extra in (
            ("hot", 2.0, True, None),
            ("hot_calibrated", 2.0, False, {"calibrated_prob_threshold": 0.93}),
            ("cold_calibrated", -12.0, False, {"calibrated_prob_threshold": 0.93}),
            ("cold_sparse", -12.0, True, None)):
        heads["semantic_head"]["bias"] = bias + shift
        out[name] = str(d / f"{name}.skoots")
        save_checkpoint(out[name], _cfg(sparse), params, dataset_mean=mean,
                        dataset_std=std, extra=extra)
        if name == "hot":
            hot_params = jax.tree_util.tree_map(lambda a: a, params)
    return img, out, model, hot_params


def _bin_width(probs, lo=0.5, bins=128):
    """The logit width of the calibration histogram's bins."""
    v = probs[probs > lo]
    t = np.log(np.clip(v, 1e-6, 1 - 1e-7)) - np.log(np.clip(1 - v, 1e-7, 1))
    return (t.max() - t.min()) / bins


def _logit(p):
    return float(np.log(p) - np.log1p(-p))


def test_probe_matches_jax(ckpts):
    """The probe on the tiny sparse checkpoint, both packages, on the four
    centre-most 32x32x8 tiles: the same threshold or the same bin."""
    img, paths, jmodel, jparams = ckpts
    mean, std = float(img.mean()), float(img.std())
    geom = ((32, 32, 8), (0, 0, 0))
    want = jax_probe(jmodel, jparams, mean, std, img[..., None], *geom)
    tmodel = model_from_checkpoint(load_checkpoint(paths["hot"]), device="cpu")
    got = _probe_semantic_threshold(tmodel, mean, std, img[..., None], *geom, "cpu")
    probs = _probe_probabilities(tmodel, mean, std, img[..., None], *geom, "cpu")
    print(f"threshold jax {want} torch {got}; bin width {_bin_width(probs):.4f}")
    assert want is not None and got is not None
    assert abs(_logit(got) - _logit(want)) <= _bin_width(probs)


def _sidecar_threshold(stem):
    with open(stem + "_skoots_phase1.json") as f:
        return json.load(f)["semantic_threshold"]


@pytest.mark.parametrize("name,source", [("hot_calibrated", "probe"),
                                         ("cold_calibrated", "checkpoint"),
                                         ("cold_sparse", "prob_threshold")])
def test_threshold_resolution_order_matches_jax(ckpts, tmp_path, name, source):
    """A sparse checkpoint's semantic gate: the probe's threshold where the
    probe finds foreground, else the checkpoint's calibrated one, else
    ``prob_threshold``; as the JAX package resolves it (host engine, the
    phase-1 sidecar records the gate)."""
    img, paths, _, _ = ckpts
    jax_imsave(str(tmp_path / "jax.tif"), img)
    np.save(tmp_path / "torch.npy", img)
    jax_run(str(tmp_path / "jax.tif"), paths[name], engine_impl="host", **KW)
    run_inference(str(tmp_path / "torch.npy"), paths[name], engine_impl="host",
                  device="cpu", output_path=str(tmp_path / "m.npy"), **KW)
    want = _sidecar_threshold(str(tmp_path / "jax"))
    got = _sidecar_threshold(str(tmp_path / "torch"))
    if source == "probe":
        assert got not in (0.93, 0.8) and want not in (0.93, 0.8)
        tmodel = model_from_checkpoint(load_checkpoint(paths[name]), device="cpu")
        mean, std = float(img.mean()), float(img.std())
        probe = _probe_semantic_threshold(tmodel, mean, std, img[..., None],
                                          (32, 32, 8), (0, 0, 0), "cpu")
        assert got == probe
        probs = _probe_probabilities(tmodel, mean, std, img[..., None],
                                     (32, 32, 8), (0, 0, 0), "cpu")
        assert abs(_logit(got) - _logit(want)) <= _bin_width(probs)
    else:
        assert got == want == {"checkpoint": 0.93, "prob_threshold": 0.8}[source]


def _artifact(kind: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    if kind == "vectors":
        return rng.uniform(-1.0, 1.0, (12, 10, 6, 3)).astype(np.float32)
    if kind == "labels":
        return rng.integers(0, 1000, (12, 10, 6)).astype(np.int32)
    return rng.uniform(0.0, 1.0, (12, 10, 6, 1)).astype(np.float32)


@pytest.mark.parametrize("kind", ["vectors", "labels", "probabilities"])
def test_convert_matches_jax(tmp_path, kind):
    """``--convert`` through both CLIs on the same ``.npy`` artifact: the
    same files, equal arrays read back."""
    arr = _artifact(kind)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        np.save(tmp_path / side / "a.npy", arr)
    assert jax_cli(["--convert", str(tmp_path / "jax" / "a.npy")]) == 0
    assert torch_cli(["--convert", str(tmp_path / "torch" / "a.npy")]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    tifs = [n for n in names if n.endswith(".tif")]
    assert len(tifs) == (3 if kind == "vectors" else 1)
    for n in tifs:
        want = imread(str(tmp_path / "jax" / n))
        got = imread(str(tmp_path / "torch" / n))
        assert got.dtype == want.dtype and got.shape == arr.shape[:3]
        np.testing.assert_array_equal(got, want)
