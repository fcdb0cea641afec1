"""The port's public library surface against the JAX package's.

Every name in the ``__all__`` of each of the JAX package's subpackages
(read with ``ast``, without importing them) is in the port's ``__all__``
and imports from it; the one documented exception is the kernels package,
whose Pallas bake ``bake_skeleton_pallas`` is the port's
``bake_skeleton_kernel``. Then the functions the port added for that
surface, on the same seeded inputs through both packages: exact where the
arithmetic is (erosion, median, crops, ``split_output``,
``suggest_dist_thr``), within 1e-6 of the reference's largest magnitude
where XLA on the CPU may fuse a multiply-add (mean and Gaussian filters,
``split_loss``), and the cfg node's behaviour (attribute access, freezing,
its errors and messages, the strict and lenient merges, a YAML file).
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from skoots_tpu import config as JC
from skoots_tpu.infer.autoknobs import suggest_dist_thr as jax_suggest_dist_thr
from skoots_tpu.models.spatial_embedding import split_output as jax_split_output
from skoots_tpu.ops import cropper as JCrop
from skoots_tpu.ops import morphology as JM
from skoots_tpu.train.losses import split_loss as jax_split_loss
from skoots_tpu_torch import config as TC
from skoots_tpu_torch.infer.autoknobs import suggest_dist_thr
from skoots_tpu_torch.models import split_output
from skoots_tpu_torch.ops import cropper as TCrop
from skoots_tpu_torch.ops import morphology as TM
from skoots_tpu_torch.train import split_loss

ROOT = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("infer", "models", "ops", "train", "utils", "validate", "parallel", "kernels")
# the JAX name -> the port's, where they differ (a TPU kernel's name)
RENAMED = {("kernels", "bake_skeleton_pallas"): "bake_skeleton_kernel"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_all(sub: str) -> list:
    tree = ast.parse((ROOT / "skoots_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"skoots_tpu/{sub}/__init__.py has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_the_jax_packages_names(sub):
    want = [RENAMED.get((sub, n), n) for n in _jax_all(sub)]
    assert want, sub
    mod = importlib.import_module(f"skoots_tpu_torch.{sub}")
    assert set(want) <= set(mod.__all__), set(want) - set(mod.__all__)
    for name in want:
        ns = {}
        exec(f"from skoots_tpu_torch.{sub} import {name}", ns)
        assert ns[name] is getattr(mod, name) and ns[name] is not None, name


RNG = np.random.default_rng(16)
BINARY = (RNG.random((2, 11, 9, 7, 2)) > 0.08).astype(np.uint8)
FLOAT = RNG.standard_normal((2, 11, 9, 7, 2)).astype(np.float32)
WINDOWS = [(3, 3, 3), (3, 3, 1), (5, 3, 1)]


def _close(got, want, rel=1e-6):
    """Within ``rel`` of the reference's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_binary_erosion_matches_jax(kind, window):
    x = BINARY if kind == "binary" else FLOAT
    want = np.asarray(JM.binary_erosion(jnp.asarray(x), window))
    got = TM.binary_erosion(torch.from_numpy(x), window).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if kind == "binary":
        assert 0 < want.sum() < x.sum()  # the edges and holes eroded


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("kind", ["binary", "float"])
def test_median_filter_matches_jax(kind, window):
    """Exact, the borders wrapping around as JAX's ``jnp.roll``; integer
    input gives f32 as ``jnp.median`` does."""
    x = BINARY if kind == "binary" else FLOAT
    want = np.asarray(JM.median_filter(jnp.asarray(x), window))
    got = TM.median_filter(torch.from_numpy(x), window).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_median_filter_wraps_at_the_border():
    """A speck on the first plane reaches the last plane's median window."""
    x = np.zeros((1, 5, 5, 5, 1), np.float32)
    x[0, 0, 1:4, 1:4, 0] = 9.0
    x[0, 4, 1:4, 1:4, 0] = 9.0
    want = np.asarray(JM.median_filter(jnp.asarray(x)))
    got = TM.median_filter(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 2, 2, 0] == 9.0  # from the wrapped-around last plane


@pytest.mark.parametrize("window", WINDOWS)
def test_mean_filter_matches_jax(window):
    _close(TM.mean_filter(torch.from_numpy(FLOAT), window),
           JM.mean_filter(jnp.asarray(FLOAT), window))
    _close(TM.mean_filter(torch.from_numpy(BINARY), window),
           JM.mean_filter(jnp.asarray(BINARY), window))


@pytest.mark.parametrize("kernel,sigma", [((3, 3, 3), (1.0, 1.0, 1.0)),
                                          ((5, 5, 3), (2.0, 1.5, 0.7)),
                                          ((1, 7, 3), (1.0, 3.0, 2.0))])
def test_gauss_filter_matches_jax(kernel, sigma):
    want = JM.gauss_filter(jnp.asarray(FLOAT), kernel, sigma)
    got = TM.gauss_filter(torch.from_numpy(FLOAT), kernel, sigma)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("n_iter,alpha", [(2, 2.0), (1, 1.5), (3, 2.0)])
def test_split_loss_matches_jax(n_iter, alpha):
    pred = RNG.random((2, 12, 10, 8, 1)).astype(np.float32)
    gt = np.zeros((2, 12, 10, 8, 1), np.float32)
    gt[:, 2:10, 2:8, 1:7] = 1.0
    want = float(jax_split_loss(n_iter, alpha)(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(split_loss(n_iter, alpha)(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("shape,crop,overlap", [((40, 33, 9), (16, 16, 8), (2, 2, 1)),
                                                ((10, 10, 5), (16, 16, 8), (0, 0, 0)),
                                                ((64, 48, 20), (32, 32, 8), (4, 4, 2))])
def test_crops_match_jax(shape, crop, overlap):
    vol = RNG.integers(0, 255, shape + (1,), dtype=np.uint8)
    assert TCrop.get_total_num_crops(shape, crop, overlap) == \
        JCrop.get_total_num_crops(shape, crop, overlap)
    want = list(JCrop.crops(vol, crop, overlap))
    got = list(TCrop.crops(vol, crop, overlap))
    assert [o for _, o in got] == [o for _, o in want] and len(want) >= 1
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a tensor volume crops as views of itself
    t = torch.from_numpy(vol[..., 0])
    for (g, o), (w, _) in zip(TCrop.crops(t, crop, overlap), want):
        np.testing.assert_array_equal(g.numpy(), w[..., 0])


def test_split_output_matches_jax():
    out = RNG.standard_normal((1, 6, 5, 4, 5)).astype(np.float32)
    for g, w in zip(split_output(torch.from_numpy(out)), jax_split_output(jnp.asarray(out))):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("radius", [None, 0.0, -1.0, 4.0, 3.14159, 7.25, 12])
def test_suggest_dist_thr_matches_jax(radius):
    assert suggest_dist_thr(radius) == jax_suggest_dist_thr(radius)


def _raised(fn):
    """``(exception type, message)`` of what ``fn()`` raises."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_cfg_node_attribute_access_and_freezing():
    j, t = JC.get_cfg_defaults(), TC.get_cfg_defaults()
    assert isinstance(t, TC.CfgNode) and isinstance(t.MODEL, TC.CfgNode)
    assert t.MODEL.DIMS == j.MODEL.DIMS and t["MODEL"]["DIMS"] is t.MODEL.DIMS
    assert TC.to_plain(t.to_dict()) == TC.to_plain(j.to_dict())
    for node in (j, t):
        node.TRAIN.SEED = 7
        node.freeze()
    assert t.is_frozen() and t.MODEL.is_frozen()
    assert _raised(lambda: setattr(t.MODEL, "DIMS", [1])) == \
        _raised(lambda: setattr(j.MODEL, "DIMS", [1]))
    assert _raised(lambda: t.merge_from_dict({"TRAIN": {"SEED": 1}})) == \
        _raised(lambda: j.merge_from_dict({"TRAIN": {"SEED": 1}}))
    assert _raised(lambda: t.NOPE) == _raised(lambda: j.NOPE)
    clone = t.clone()
    assert not clone.is_frozen() and clone == t and clone.TRAIN.SEED == 7
    t.defrost()
    t.TRAIN.SEED = 8
    assert t.TRAIN.SEED == 8 and not t.MODEL.is_frozen()


def test_cfg_node_merge_errors_match_jax():
    for bad in ({"MODEL": {"NOT_A_KEY": 1}}, {"NOPE": {}}, {"MODEL": 3}):
        assert _raised(lambda: TC.get_cfg_defaults().merge_from_dict(bad)) == \
            _raised(lambda: JC.get_cfg_defaults().merge_from_dict(bad))
    assert _raised(lambda: TC.cfg_from_dict({"MODEL": {"X": 1}}, strict=True)) == \
        _raised(lambda: JC.cfg_from_dict({"MODEL": {"X": 1}}, strict=True))
    assert _raised(lambda: TC.cfg_from_dict({"MODEL": {"X": 1}}, strict=True))[0] is KeyError


@pytest.mark.parametrize("strict", [False, True])
def test_cfg_from_dict_matches_jax(strict):
    d = {"MODEL": {"DIMS": [4, 8, 4], "DEPTHS": [1, 1, 1]},
         "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}, "TRAIN": {"LEARNING_RATE": 1}}
    if not strict:
        d["FUTURE"] = {"KNOB": [1, 2], "SUB": {"A": None}}
        d["MODEL"]["NEW_KEY"] = "x"
    j, t = JC.cfg_from_dict(d, strict=strict), TC.cfg_from_dict(d, strict=strict)
    assert isinstance(t, TC.CfgNode) and not t.is_frozen()
    assert t == j.to_dict() and t.to_dict() == j.to_dict()
    assert t.SKOOTS.VECTOR_SCALING == (8, 8, 4) and t.TRAIN.LEARNING_RATE == 1.0
    if not strict:
        assert isinstance(t.FUTURE.SUB, TC.CfgNode) and t.MODEL.NEW_KEY == "x"


@pytest.mark.parametrize("freeze", [True, False])
def test_load_cfg_from_file_matches_jax(tmp_path, freeze):
    """The training cfg JAX's CLI test writes (``tests/test_train_e2e.py``),
    read by both packages: the same node, frozen as asked, and its dump
    read back equal."""
    cfg = {
        "MODEL": {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
                  "KERNEL_SIZE": 3},
        "TRAIN": {"TRAIN_DATA_DIR": ["/data/train"], "TRAIN_SAMPLE_PER_IMAGE": [4],
                  "TRAIN_BATCH_SIZE": 1, "TRAIN_STORE_DATA_ON_GPU": [False],
                  "NUM_EPOCHS": 2, "SAVE_INTERVAL": 2, "SAVE_PATH": "/tmp/models",
                  "MAX_SKELETON_POINTS": 128, "VALIDATE_EPOCH_SKIP": 10,
                  "LOSS_SKELETON_START_EPOCH": -1},
        "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8},
        "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
    }
    p = tmp_path / "test.yaml"
    p.write_text(yaml.safe_dump(cfg))
    j = JC.load_cfg_from_file(str(p), freeze=freeze)
    t = TC.load_cfg_from_file(str(p), freeze=freeze)
    assert isinstance(t, TC.CfgNode) and t.is_frozen() == j.is_frozen() == freeze
    assert t.to_dict() == j.to_dict()
    assert TC.load_yaml(t.dump()) == yaml.safe_load(j.dump()) == TC.to_plain(j.to_dict())
    if freeze:
        assert _raised(lambda: setattr(t, "SYSTEM", 1)) == _raised(lambda: setattr(j, "SYSTEM", 1))
