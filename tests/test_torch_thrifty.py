"""The port's device-thrifty pipeline (``infer/device_pipeline.py::
make_thrifty_pipeline``) and its engine choice against the JAX package's,
on the CPU.

* ``run_inference(engine_impl="device-thrifty")`` in both packages on the
  setup of ``tests/test_inference.py``'s thrifty test (``make_tubes``
  64x64x8, crops 32x32x8, no overlap) with a tiny f32 checkpoint whose
  heads find four instances: the same instance count, every instance at
  IoU >= 0.95, int32 output, ``"engine": "device-thrifty"``.
* ``auto`` takes the thrifty pipeline exactly where only its estimate fits
  the device's free memory.
* The pipeline itself: 16-bit labels numbered 1..N in the CC's root order,
  the same partition as the chunked pipeline's from the same tiles (exact:
  with no halo and assign tiles equal to the forward tiles both walk the
  same f16 field), and a uint16 volume segmented as its uint8 copy.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.infer.engine import run_inference as jax_run
from skoots_tpu.ops import flood_fill as jff
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import save_checkpoint
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.infer import device_pipeline as tdp
from skoots_tpu_torch.infer import engine, sharded
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.ops import flood_fill as tff

from test_torch_pipeline import _match_instances

KW = dict(crop_size=(32, 32, 8), overlap=(0, 0, 0), assign_crop_size=(32, 32, 8),
          assign_overlap=(0, 0, 0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work is thousands of small CPU ops; under the
    suite's parallel workers each op's thread pool waits on the others'
    (the module ran 15x slower than alone), so it runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hot(tmp_path_factory):
    """(checkpoint path, u8 volume 64x64x8) of a tiny f32 UNeXT with random
    weights, the semantic head's bias raised by 2 and the vector head
    shrunk, so the walks are short and land on four skeletons."""
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 16, 8, 4], [1, 1, 1, 1, 1]
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 4, 3
    cfg.MODEL.DTYPE = "float32"
    cfg.SKOOTS.VECTOR_SCALING = [4.0, 4.0, 2.0]
    cfg.freeze()
    _, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.5, jnp.float32), params)
    heads = params["params"]
    heads["semantic_head"]["bias"] = heads["semantic_head"]["bias"] + 2.0
    heads["vector_head"]["kernel"] = heads["vector_head"]["kernel"] * 0.1
    heads["vector_head"]["bias"] = heads["vector_head"]["bias"] * 0.0
    img, _, _ = make_tubes(shape=(64, 64, 8), n_tubes=2)
    path = str(tmp_path_factory.mktemp("thrifty") / "hot.skoots")
    save_checkpoint(path, cfg, params, dataset_mean=float(img.mean()),
                    dataset_std=float(img.std()))
    return path, img


def _phases(stem):
    with open(stem + "_skoots_phases.json") as f:
        return json.load(f)


def test_thrifty_engine_matches_jax(hot, tmp_path):
    ckpt, img = hot
    jax_imsave(str(tmp_path / "jax.tif"), img)
    np.save(tmp_path / "torch.npy", img)
    want = jax_run(str(tmp_path / "jax.tif"), ckpt, engine_impl="device-thrifty", **KW)
    got = engine.run_inference(str(tmp_path / "torch.npy"), ckpt,
                               engine_impl="device-thrifty", device="cpu",
                               output_path=str(tmp_path / "mask.npy"), **KW)
    assert got.dtype == np.int32 and got.shape == want.shape
    assert _phases(str(tmp_path / "torch"))["engine"] == "device-thrifty"
    assert _phases(str(tmp_path / "jax"))["engine"] == "device-thrifty"
    n_want, n_got, ious = _match_instances(want, got)
    print(f"instances jax {n_want} torch {n_got}; IoUs {[round(i, 4) for i in ious]}; "
          f"{int((want != got).sum())} voxels differ")
    assert n_want == 4 and n_got == n_want
    assert min(ious) >= 0.95
    np.testing.assert_array_equal(np.load(tmp_path / "mask.npy"), got)


@pytest.mark.parametrize("per_voxel,tile_bytes,engine_name", [
    (24, 0, "device"), (13, 0, "device-thrifty"), (12, 0, "host"),
    (24, 5000, "device-thrifty"), (13, 5000, "host")])
def test_auto_takes_thrifty_where_only_it_fits(hot, tmp_path, monkeypatch, per_voxel,
                                               tile_bytes, engine_name):
    """``auto`` (past the host engine's size) takes the chunked pipeline
    where its 24 B a voxel and one forward tile's peak fit the device's
    free memory, the thrifty one where only its 13 B (a uint8 volume) and
    the tile do, and the host engine where neither does."""
    ckpt, img = hot
    assert img.dtype == np.uint8
    np.save(tmp_path / "v.npy", img)
    monkeypatch.setattr(engine, "HOST_ENGINE_MAX_VOXELS", 0)
    monkeypatch.setattr(sharded, "device_bytes_limit",
                        lambda device: per_voxel * img.size)
    monkeypatch.setattr(engine, "_forward_tile_bytes", lambda *a: tile_bytes)
    mask = engine.run_inference(str(tmp_path / "v.npy"), ckpt, device="cpu",
                                output_path=str(tmp_path / "m.npy"), **KW)
    phases = _phases(str(tmp_path / "v"))
    assert phases["engine"] == engine_name
    assert phases["auto"] == {
        "free_bytes": per_voxel * img.size, "tile_bytes": tile_bytes,
        "estimated_bytes": {"device": 24 * img.size + tile_bytes,
                            "device-thrifty": 13 * img.size + tile_bytes}}
    if engine_name == "device-thrifty":
        explicit = engine.run_inference(str(tmp_path / "v.npy"), ckpt,
                                        engine_impl="device-thrifty", device="cpu",
                                        output_path=str(tmp_path / "e.npy"), **KW)
        np.testing.assert_array_equal(mask, explicit)


def test_thrifty_labels_are_16_bit_and_numbered_1_to_n(hot):
    """The pipeline returns uint16 labels in 1..N (N = ``last_count``, the
    CC's components) in the CC's root order, and the chunked pipeline's
    partition of the volume: with no halo and the assign tiles equal to
    the forward tiles, the recomputed f16 field is the chunked pipeline's
    stored one (its buffer at f16)."""
    ckpt, img = hot
    model = model_from_checkpoint(load_checkpoint(ckpt), device="cpu")
    knobs = dict(crop=(32, 32, 8), overlap=(0, 0, 0), assign_crop=(32, 32, 8),
                 vector_scale=(4.0, 4.0, 2.0), embed_compact_div=16,
                 dilation_3d=1, dilation_2d=2, device="cpu")
    mean, std = float(img.mean()), float(img.std())
    run = tdp.make_thrifty_pipeline(model, img.shape, **knobs)
    got = run(img, mean, std)
    assert got.dtype == torch.uint16 and tuple(got.shape) == img.shape
    assert run.tile_plan == {"forward": 4, "assign": 4}
    assert set(run.last_phase_s) == {"1-forward", "2-cc", "3-assign"}
    got = tff.widen_u16(got).numpy()
    ids = np.unique(got)
    assert ids[0] == 0 and 4 <= len(ids) - 1 <= run.last_count < 2**16
    assert ids[-1] <= run.last_count

    chunked = tdp.make_chunked_pipeline(model, img.shape, dtype=torch.float16,
                                        **knobs)(img, mean, std).numpy()
    pairs = np.unique(np.stack([chunked.ravel(), got.ravel()], 1), axis=0)
    assert len(pairs) == len(ids) and len(np.unique(pairs[:, 0])) == len(ids)
    assert (pairs[0] == 0).all() and (np.diff(pairs[:, 1]) > 0).all()


def test_thrifty_takes_a_uint16_volume(hot):
    """A uint16 volume stays 16-bit on the device (reflect-padded through
    its int16 view) and segments exactly as its uint8 and f32 copies."""
    ckpt, img = hot
    model = model_from_checkpoint(load_checkpoint(ckpt), device="cpu")
    run = tdp.make_thrifty_pipeline(model, img.shape, crop=(32, 32, 8),
                                    overlap=(4, 4, 2), assign_crop=(32, 32, 8),
                                    vector_scale=(4.0, 4.0, 2.0), device="cpu")
    mean, std = float(img.mean()), float(img.std())
    masks = [tff.widen_u16(run(torch.from_numpy(img.astype(dt)), mean, std))
             for dt in (np.uint8, np.uint16, np.float32)]
    assert int(masks[0].max()) >= 1
    for m in masks[1:]:
        assert torch.equal(m, masks[0])


def test_u16_narrow_and_widen_round_trip():
    labels = torch.arange(2**16, dtype=torch.int32).flip(0).view(16, 64, 64)
    narrow = tff.narrow_u16(labels)
    assert narrow.dtype == torch.uint16
    assert torch.equal(tff.widen_u16(narrow), labels)
    assert tff.widen_u16(labels) is labels


@pytest.mark.parametrize("max_rounds", [2, 96])
def test_lean_cc_and_compaction_match_jax_across_slabs(monkeypatch, max_rounds):
    """The whole-volume CC (two label volumes: the propagation's second
    buffer is the jump's output; convergence read from the labels' sum)
    and the compaction (slab by slab, in place or into 16 bits) on slabs
    of 97 voxels, which split rows: the JAX package's labels, round count
    and convergence, also when the rounds run out first, and its
    compaction."""
    monkeypatch.setattr(tff, "SLAB_VOXELS", 97)
    rng = np.random.default_rng(3)
    mask = (rng.random((20, 18, 12)) < 0.12).astype(np.uint8)
    jlab = jff.make_label_components_stepped(
        mask.shape, rounds_per_dispatch=1, propagates_per_round=2,
        jumps_per_round=1, propagate_impl="xla")
    tlab = tff.make_label_components_stepped(
        mask.shape, rounds_per_dispatch=1, propagates_per_round=2,
        jumps_per_round=1)
    want = np.asarray(jlab(jnp.asarray(mask), max_rounds=max_rounds))
    got = tlab(torch.from_numpy(mask), max_rounds=max_rounds)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tlab.last_rounds == jlab.last_rounds
    assert tlab.last_converged == jlab.last_converged == (max_rounds == 96)

    wc, wn = jff._compact_labels(jnp.asarray(want))
    wc = np.asarray(wc)
    assert 2 <= int(wn) < 2**16
    narrow, n = tff._compact_labels(got.clone(), narrow16=True)
    assert n == int(wn) and narrow.dtype == torch.int16
    np.testing.assert_array_equal(tff.widen_u16(narrow.view(torch.uint16)).numpy(), wc)
    inplace, n = tff._compact_labels(got, narrow16=False)
    assert n == int(wn) and inplace.dtype == torch.int32
    assert inplace.data_ptr() == got.data_ptr()
    np.testing.assert_array_equal(inplace.numpy(), wc)
