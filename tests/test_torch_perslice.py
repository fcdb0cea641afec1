"""The port's per-slice 2D mode (``infer/perslice.py``) against the JAX
package's, on the CPU: the 2D walk, the batched per-slice CC (all slices in
one stepped CC, also when the round cap cuts a slice short), and
``perslice_segment`` are compared for exact equality; ``run_perslice_inference``
on a tif with a tiny f32 checkpoint gives JAX's mask from the same cached
buffers, and from scratch JAX's instance count with every instance at IoU
>= 0.95."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.infer.perslice import perslice_segment as jax_perslice
from skoots_tpu.infer.perslice import run_perslice_inference as jax_run_perslice
from skoots_tpu.ops.flood_fill import label_components as jax_label_components
from skoots_tpu.ops.vec2embed import vector_to_embedding as jax_walk
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu_torch.infer.perslice import (perslice_label_components, perslice_segment,
                                             run_perslice_inference)
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.utils.io import imread
from skoots_tpu_torch.utils.synthetic import make_tubes

from test_torch_mask_tools import jax_pallas_perfect_prediction
from test_torch_pipeline import _match_instances
from test_torch_thrifty import hot  # noqa: F401

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [1, 5, 10])
def test_2d_walk_matches_jax(n):
    """The walk on ``[Z, X, Y, 2]`` (z the batch axis) with ``scale[:2]``."""
    rng = np.random.default_rng(n)
    vec = rng.uniform(-1, 1, (5, 24, 20, 2)).astype(np.float32)
    vec[rng.random(vec.shape[:-1]) < 0.3] = 0
    scale = (12.0, 12.0)
    want = np.asarray(jax_walk(jnp.asarray(scale), jnp.asarray(vec), n=n))
    got = vector_to_embedding(scale, T(vec), n=n).numpy()
    np.testing.assert_array_equal(got, want)


def _slices_with_a_serpentine():
    """[Z, X, Y] skeleton slices: random speckle, an empty slice, a full
    one and a one-voxel serpentine (one path of 511 voxels)."""
    rng = np.random.default_rng(0)
    s = (rng.random((5, 31, 31)) < 0.35).astype(np.uint8)
    s[1] = 0
    s[2] = 1
    s[4] = 0
    s[4, 0::2] = 1
    for k, row in enumerate(range(1, 31, 2)):
        s[4, row, 30 if k % 2 == 0 else 0] = 1
    return s


def _jax_per_slice(s, max_rounds):
    return np.asarray(jax.vmap(
        lambda sl: jax_label_components(sl[..., None], max_rounds=max_rounds)[..., 0])(
            jnp.asarray(s)))


@pytest.mark.parametrize("max_rounds", [64, 3])
def test_per_slice_cc_matches_jax_vmap(max_rounds):
    """JAX vmaps ``label_components`` over z; the port labels the slices as
    the even planes of one volume. At 3 rounds the serpentine is cut short
    (its labels differ from the fixpoint's) and both cut it alike."""
    s = _slices_with_a_serpentine()
    want = _jax_per_slice(s, max_rounds)
    got = perslice_label_components(T(s), max_rounds=max_rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    converged = _jax_per_slice(s, 64)
    assert np.array_equal(want[4], converged[4]) == (max_rounds == 64)
    assert len(np.unique(converged[4])) == 2  # the serpentine is one component


@pytest.mark.parametrize("max_rounds", [64, 3])
def test_per_slice_cc_in_groups_matches_jax_vmap(max_rounds, monkeypatch):
    """Groups of two slices (one stepped CC each: 2, 2 and the serpentine
    alone) give JAX's labels too, cut short at 3 rounds as JAX cuts them."""
    from skoots_tpu_torch.infer import perslice

    s = _slices_with_a_serpentine()
    whole = perslice_label_components(T(s), max_rounds=max_rounds)
    rounds_whole = perslice_label_components.last_rounds
    monkeypatch.setattr(perslice, "SLICE_GROUP_VOXELS", 3 * 31 * 31)
    got = perslice_label_components(T(s), max_rounds=max_rounds)
    np.testing.assert_array_equal(got.numpy(), _jax_per_slice(s, max_rounds))
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    assert perslice_label_components.last_rounds > rounds_whole  # three CCs ran


@pytest.mark.parametrize("max_rounds", [64, 3])
def test_per_slice_cc_ignores_skoots_cc_scans(max_rounds, monkeypatch):
    """``SKOOTS_CC_SCANS`` steers the pipelines' CC, not the per-slice one
    (JAX's ``label_components`` reads no such variable): the same labels
    and rounds as without it, also where 3 rounds cut the serpentine short
    (an axis sweep a round would reach its fixpoint sooner)."""
    s = _slices_with_a_serpentine()
    plain = perslice_label_components(T(s), max_rounds=max_rounds)
    rounds = perslice_label_components.last_rounds
    monkeypatch.setenv("SKOOTS_CC_SCANS", "1")
    got = perslice_label_components(T(s), max_rounds=max_rounds)
    np.testing.assert_array_equal(got.numpy(), _jax_per_slice(s, max_rounds))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert perslice_label_components.last_rounds == rounds


def _oracle(labels, skels, scale):
    pred = jax_pallas_perfect_prediction(labels, skels, scale)
    return (pred[..., 0:3], (pred[..., 3] > 0.5).astype(np.uint8),
            (pred[..., 4] > 0.5).astype(np.uint8))


def test_perslice_segment_oracle_matches_jax():
    """``tests/test_perslice.py``'s separated tubes: every tube recovered,
    and JAX's mask exactly."""
    _, labels, skels = make_tubes(shape=(64, 64, 12), n_tubes=3, seed=7, min_separation=10)
    vec, skel, sem = _oracle(labels, skels, (12, 12, 6))
    want = jax_perslice(vec, skel, sem, (12, 12, 6), embed_iterations=5)
    got = perslice_segment(vec, skel, sem, (12, 12, 6), embed_iterations=5, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    n_gt, n_got, ious = _match_instances(labels, got)
    assert n_gt == 3 and n_got == 3 and min(ious) > 0.5


def test_perslice_segment_stitches_z_like_jax():
    """A z-columnar object comes out as one instance, not one a slice."""
    labels = np.zeros((16, 16, 6), np.int32)
    labels[4:9, 4:9, :] = 1
    skels = {1: np.asarray([[6.0, 6.0, float(z)] for z in range(6)], np.float32)}
    vec, skel, sem = _oracle(labels, skels, (6, 6, 3))
    want = jax_perslice(vec, skel, sem, (6, 6, 3), embed_iterations=3)
    got = perslice_segment(vec, skel, sem, (6, 6, 3), embed_iterations=3, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got[labels > 0])) == {1}


@pytest.mark.parametrize("min_size", [-1, 0, 5])
def test_perslice_segment_random_field_matches_jax(min_size):
    """A random f16 field over random skeleton and semantic masks: many
    slice-local pieces, merges across z and specks."""
    rng = np.random.default_rng(11)
    shape = (40, 36, 7)
    vec = rng.uniform(-1, 1, shape + (3,)).astype(np.float16)
    skel = (rng.random(shape) < 0.15).astype(np.uint8)
    sem = (rng.random(shape) < 0.7).astype(np.uint8)
    want = jax_perslice(vec, skel, sem, (5.0, 5.0, 2.0), embed_iterations=4,
                        min_instance_size=min_size)
    got = perslice_segment(vec, skel, sem, (5.0, 5.0, 2.0), embed_iterations=4,
                           min_instance_size=min_size, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 10


KW = dict(crop_size=(32, 32, 8), overlap=(0, 0, 0))


def test_run_perslice_inference_matches_jax(hot, tmp_path):  # noqa: F811
    """The tiny checkpoint on a 64x64x8 tif. From scratch (phase 1 run once
    by each package's engine): JAX's instance count, every instance at IoU
    >= 0.95. Given the port's cached buffers, JAX's mask exactly."""
    ckpt, img = hot
    for side in ("jax", "torch", "cached"):
        os.makedirs(tmp_path / side)
        jax_imsave(str(tmp_path / side / "v.tif"), img)
    want = jax_run_perslice(str(tmp_path / "jax" / "v.tif"), ckpt, **KW)
    got = run_perslice_inference(str(tmp_path / "torch" / "v.tif"), ckpt, device="cpu", **KW)
    assert got.dtype == np.int32 and got.shape == img.shape
    np.testing.assert_array_equal(imread(str(tmp_path / "torch" / "v_instance_mask_2d.tif")),
                                  got)
    n_want, n_got, ious = _match_instances(want, got)
    print(f"instances jax {n_want} torch {n_got}; IoUs {[round(i, 4) for i in ious]}")
    assert n_want >= 3 and n_got == n_want and min(ious) >= 0.95

    for buf in ("vectors", "skeleton", "semantic"):
        shutil.copy(tmp_path / "torch" / f"v_skoots_{buf}.npy",
                    tmp_path / "cached" / f"v_skoots_{buf}.npy")
    cached = jax_run_perslice(str(tmp_path / "cached" / "v.tif"), ckpt, **KW)
    np.testing.assert_array_equal(got, cached)
    again = run_perslice_inference(str(tmp_path / "torch" / "v.tif"), ckpt, device="cpu",
                                   output_path=str(tmp_path / "again.tif"), **KW)
    np.testing.assert_array_equal(again, got)


def test_run_perslice_inference_needs_the_stored_field(hot, tmp_path, monkeypatch):  # noqa: F811
    """Phase 1 in the recompute wire mode (as out of core, over 256^3
    voxels) stores no vector field: the mode raises, naming why (JAX's
    fails at ``np.load``)."""
    ckpt, img = hot
    np.save(tmp_path / "v.npy", img)
    monkeypatch.setenv("SKOOTS_WIRE_MODE", "recompute")
    with pytest.raises(FileNotFoundError, match="stored no vector field"):
        run_perslice_inference(str(tmp_path / "v.npy"), ckpt, device="cpu", **KW)
    assert os.path.exists(tmp_path / "v_skoots_skeleton.npy")
