"""Ground-truth skeletonisation of the port
(``skoots_tpu_torch/train/generate_skeletons.py`` and the host C++ Lee
thinning, ``csrc/host/lee_thin.cpp``) against the JAX package on the CPU."""

import os

import numpy as np
import pytest

from skoots_tpu import native as jax_native
from skoots_tpu.cli import main as jax_cli
from skoots_tpu.train import generate_skeletons as JG
from skoots_tpu.utils.io import imsave
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch.cli import main as torch_cli
from skoots_tpu_torch.train import generate_skeletons as G
from skoots_tpu_torch.utils import lee_thin as L


def _cylinder(shape=(40, 15, 15), radius=4.0):
    c = [(s - 1) / 2 for s in shape]
    idx = np.indices(shape).astype(np.float32)
    return (idx[1] - c[1]) ** 2 + (idx[2] - c[2]) ** 2 <= radius ** 2


def _blobs(shape=(28, 28, 20), n=4, seed=0):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, bool)
    idx = np.indices(shape).astype(np.float32)
    for _ in range(n):
        c = rng.uniform(4, np.asarray(shape) - 4)
        r = rng.uniform(2.5, 5.0)
        vol |= sum((idx[a] - c[a]) ** 2 for a in range(3)) <= r ** 2
    return vol


def _hollow_loop():
    vol = np.zeros((24, 24, 7), bool)
    vol[4:20, 4:20, 2:5] = True
    vol[8:16, 8:16, :] = False
    return vol


@pytest.mark.parametrize("make", [_cylinder, _blobs, _hollow_loop],
                         ids=["cylinder", "blobs", "hollow_loop"])
def test_lee_thinning_equals_jax(make):
    """The port's C++ copy deletes exactly the voxels JAX's ``lee_thin``
    deletes, on tests/test_lee_thinning.py's volumes."""
    vol = make()
    got = L.lee_thin(vol)
    assert got.dtype == bool and got.shape == vol.shape and 0 < got.sum() < vol.sum()
    np.testing.assert_array_equal(got, jax_native.lee_thin(vol))


def test_lee_library_is_built_from_the_checkout():
    """Built by the system C++ compiler under ``build/host/``, named by the
    source's hash, and kept out of the CUDA library's sources."""
    from skoots_tpu_torch.kernels import _build

    assert L.library_path().parent.parts[-2:] == ("build", "host")
    L.library()
    assert L.library_path().exists()
    assert L.SOURCE not in _build._sources()
    with pytest.raises(ValueError):
        L.lee_thin(np.ones((4, 4), bool))


@pytest.fixture(scope="module")
def labels():
    _, lab, _ = make_tubes(shape=(40, 40, 10), n_tubes=3, radius=3, seed=4)
    lab = lab.astype(np.int32)
    lab[1:3, 36:38, 0:2] = 9  # a small instance at the edge
    return lab


@pytest.mark.parametrize("method", ["lee", "medial", "teasar"])
@pytest.mark.parametrize("scale", [(1.0, 1.0, 1.0), (1.0, 1.0, 2.0)], ids=["iso", "aniso"])
def test_calculate_skeletons_equals_jax(labels, method, scale):
    want = JG.calculate_skeletons(labels, scale, method=method)
    got = G.calculate_skeletons(labels, scale, method=method)
    assert got.keys() == want.keys() and len(got) == 4
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{method} {k}")


def test_calculate_skeletons_centroid_fallback(labels, monkeypatch):
    """An instance whose skeletoniser finds no point gets its centroid, in
    the zoom's voxel-centre inverse where it was upsampled."""
    empty = lambda binary: np.zeros((0, 3), np.float32)  # noqa: E731
    monkeypatch.setattr(JG, "_medial_points", empty)
    monkeypatch.setattr(G, "_medial_points", empty)
    for scale in ((1.0, 1.0, 1.0), (2.0, 2.0, 1.5)):
        want = JG.calculate_skeletons(labels, scale, method="medial")
        got = G.calculate_skeletons(labels, scale, method="medial")
        assert all(v.shape == (1, 3) for v in got.values())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        G.calculate_skeletons(labels, method="kimimaro")


def _npz_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _tif_dirs(tmp_path, labels):
    dirs = []
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        for i in range(2):
            imsave(str(d / f"v{i}.seg.tif"), np.roll(labels, 5 * i, axis=0))
            imsave(str(d / f"v{i}.tif"), np.zeros(labels.shape, np.uint8))
        dirs.append(d)
    return dirs


def test_create_gt_skeletons_and_split_equal_jax(tmp_path, labels):
    jd, td = _tif_dirs(tmp_path, labels)
    JG.create_gt_skeletons(str(jd), mask_suffix=".seg.tif", scale=(1.0, 1.0, 2.0),
                           method="lee")
    G.create_gt_skeletons(str(td), mask_suffix=".seg.tif", scale=(1.0, 1.0, 2.0),
                          method="lee")
    for i in range(2):
        _npz_equal(jd / f"v{i}.skeletons.npz", td / f"v{i}.skeletons.npz")
    skels = G.load_skeletons(str(td / "v0.skeletons.npz"))
    JG.save_train_test_split(labels, skels, 5, str(jd / "split"))
    G.save_train_test_split(labels, skels, 5, str(td / "split"))
    for part in ("_train", "_validate"):
        _npz_equal(jd / f"split{part}.skeletons.npz", td / f"split{part}.skeletons.npz")


def test_skeletonize_train_data_cli_equals_skoots(tmp_path, labels):
    """``skoots-torch --skeletonize-train-data DIR`` writes the files
    ``skoots`` writes, with the same mask filter, downscale and method."""
    jd, td = _tif_dirs(tmp_path, labels)
    args = ["--mask-filter", ".seg", "--downscaleZ", "0.5", "--skeletonize-method", "lee",
            "--log", "0"]
    assert jax_cli(["--skeletonize-train-data", str(jd)] + args) == 0
    assert torch_cli(["--skeletonize-train-data", str(td)] + args) == 0
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    written = [f for f in os.listdir(td) if f.endswith(".skeletons.npz")]
    assert len(written) == 2
    for f in written:
        _npz_equal(jd / f, td / f)
