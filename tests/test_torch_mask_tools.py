"""The port's mask tools and synthetic helpers against the JAX package's,
on the CPU: ``watershed_and_stitch``, ``remove_margin``,
``load_renumber_save``, ``make_blobs``, ``apply_em_realism`` and
``perfect_prediction`` (exact equality; files read back through each
package's own reader)."""

import numpy as np
import pytest
import torch

from skoots_tpu.kernels.bake import bake_skeleton_pallas
from skoots_tpu.ops import skeleton as jax_skeleton
from skoots_tpu.utils import synthetic as jsyn
from skoots_tpu.utils.flood_and_stitch import watershed_and_stitch as jax_stitch
from skoots_tpu.utils.io import imread as jax_imread
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu.utils.remove_margin import remove_margin as jax_remove_margin
from skoots_tpu.utils.renumber import load_renumber_save as jax_renumber_save
from skoots_tpu_torch.utils import synthetic as tsyn
from skoots_tpu_torch.utils.flood_and_stitch import watershed_and_stitch
from skoots_tpu_torch.utils.io import imread
from skoots_tpu_torch.utils.remove_margin import remove_margin
from skoots_tpu_torch.utils.renumber import load_renumber_save


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_pallas_perfect_prediction(labels, skeletons, vector_scale):
    """JAX's ``perfect_prediction`` with its bake on the Pallas kernel (in
    interpret mode), the TPU kernel the port's bake replaces. On the CPU
    JAX's ``auto`` takes its matmul route, whose ``|c|^2 + |s|^2 - 2 c.s``
    distances round differently and can pick the other of two nearly
    equidistant points."""

    def bake(masks, skels, anisotropy=(1.0, 1.0, 1.0), average=True, **_):
        packed = jax_skeleton.pack_skeletons(skels)
        baked, _ = bake_skeleton_pallas(masks, packed.points, packed.ids, anisotropy,
                                        interpret=True)
        assert not average
        return baked

    saved, jax_skeleton.bake_skeleton = jax_skeleton.bake_skeleton, bake
    try:
        return jsyn.perfect_prediction(labels, skeletons, vector_scale=vector_scale)
    finally:
        jax_skeleton.bake_skeleton = saved


def _stitch_case():
    """Blobs cut into slabs that touch across slices, with a pair whose
    majority partner differs by direction, and specks."""
    rng = np.random.default_rng(4)
    m = rng.random((20, 18, 9)) < 0.08
    m[2:9, 2:9, :] = True
    m[12:17, 3:7, 2:6] = True
    m[11:18, 6:8, 4:8] = True
    return m.astype(np.uint8)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_watershed_and_stitch_matches_jax(dim):
    m = _stitch_case()
    want = jax_stitch(m, dim=dim)
    got = watershed_and_stitch(m, dim=dim)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and len(np.unique(want)) > 5


def test_watershed_and_stitch_single_slice_matches_jax():
    m = _stitch_case()[:, :, 3:4]
    np.testing.assert_array_equal(watershed_and_stitch(m), jax_stitch(m))


def test_remove_margin_writes_what_jax_writes(tmp_path):
    vol = np.random.default_rng(0).integers(0, 255, (24, 20, 12)).astype(np.uint8)
    jax_imsave(str(tmp_path / "v.tif"), vol)
    want = jax_remove_margin(str(tmp_path / "v.tif"), margin=(5, 4, 2),
                             output_path=str(tmp_path / "jax.tif"))
    got = remove_margin(str(tmp_path / "v.tif"), margin=(5, 4, 2))
    assert got == str(tmp_path / "v_cropped.tif")
    a, b = jax_imread(want), imread(got)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(jax_imread(got), a)
    assert b.shape == (14, 12, 8)
    with pytest.raises(ValueError, match="too large"):
        remove_margin(str(tmp_path / "v.tif"), margin=(12, 0, 0))


def test_load_renumber_save_writes_what_jax_writes(tmp_path):
    lab = np.random.default_rng(1).choice([0, 7, 300, 4096, 70000], (16, 12, 6))
    lab = lab.astype(np.int32)
    for side in ("jax", "torch"):
        jax_imsave(str(tmp_path / f"{side}.tif"), lab)
    jax_renumber_save(str(tmp_path / "jax.tif"))
    assert load_renumber_save(str(tmp_path / "torch.tif")) == str(tmp_path / "torch.tif")
    want = jax_imread(str(tmp_path / "jax.tif"))
    np.testing.assert_array_equal(imread(str(tmp_path / "torch.tif")), want)
    np.testing.assert_array_equal(jax_imread(str(tmp_path / "torch.tif")), want)
    assert sorted(np.unique(want)) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("seed", [101196, 5])
def test_make_blobs_and_em_realism_match_jax(seed):
    kw = dict(shape=(48, 40, 12), n_blobs=5, radius_range=(4, 8), seed=seed)
    want = jsyn.make_blobs(**kw)
    got = tsyn.make_blobs(**kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        np.testing.assert_array_equal(got[2][k], want[2][k])
    image, labels = want[0], want[1]
    np.testing.assert_array_equal(tsyn.apply_em_realism(image, labels, seed=seed),
                                  jsyn.apply_em_realism(image, labels, seed=seed))


def test_make_tubes_min_separation_matches_jax():
    for kw in (dict(shape=(64, 64, 12), n_tubes=3, seed=7, min_separation=10),
               dict(shape=(48, 48, 8), n_tubes=6, seed=2, min_separation=30.0)):
        want, got = jsyn.make_tubes(**kw), tsyn.make_tubes(**kw)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert sorted(got[2]) == sorted(want[2])


@pytest.mark.parametrize("scale", [(12, 12, 6), (60.0, 60.0, 12.0)])
def test_perfect_prediction_matches_jax(scale):
    _, labels, skels = tsyn.make_tubes(shape=(48, 48, 10), n_tubes=3, seed=7,
                                       min_separation=10)
    want = jax_pallas_perfect_prediction(labels, skels, scale)
    got = tsyn.perfect_prediction(labels, skels, vector_scale=scale, device="cpu")
    assert got.dtype == np.float32 and got.shape == labels.shape + (5,)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 3] > 0).sum() > 100
