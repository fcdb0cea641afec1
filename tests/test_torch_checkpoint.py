"""The port's ``.skoots`` reader against msgpack + flax's restore, and the
flax -> PyTorch weight bridge."""

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import MAGIC, save_checkpoint
from skoots_tpu_torch.checkpoint import load_checkpoint, torch_params_from_flax
from skoots_tpu_torch.models import cfg_to_model

BENCH = "runs/bench_ckpt.skoots"


def _flax_state(path):
    with open(path, "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
        return serialization.msgpack_restore(f.read())


def _assert_same_tree(got, want, where="state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, "dtype"):
        w = np.asarray(want)
        g = np.asarray(got)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        assert got == want and type(got) is type(want), where


def _tiny_cfg():
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS = [4, 8, 4]
    cfg.MODEL.DEPTHS = [2, 1, 2]
    cfg.MODEL.OUT_CHANNELS = 8
    cfg.MODEL.KERNEL_SIZE = 3
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = _tiny_cfg()
    _, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.skoots")
    save_checkpoint(path, cfg, params, opt_state=optax.adam(1e-3).init(params),
                    dataset_mean=41.75, dataset_std=20.5,
                    extra={"note": "tiny", "steps": [1, 2], "flag": True,
                           "none": None, "big": 2 ** 40, "neg": -7})
    return path


@pytest.mark.parametrize("which", ["bench", "tiny"])
def test_decoder_matches_flax_restore(which, tiny_ckpt):
    path = BENCH if which == "bench" else tiny_ckpt
    _assert_same_tree(load_checkpoint(path), _flax_state(path))


def test_bad_magic_raises(tmp_path):
    p = tmp_path / "x.skoots"
    p.write_bytes(b"NOTSKOOTS0" + b"\x80")
    with pytest.raises(RuntimeError, match="magic"):
        load_checkpoint(str(p))


@pytest.mark.parametrize("which", ["bench", "tiny"])
def test_bridge_maps_every_leaf(which, tiny_ckpt):
    path = BENCH if which == "bench" else tiny_ckpt
    ckpt = load_checkpoint(path)
    flax_leaves = jax.tree_util.tree_leaves(ckpt["params"])
    sd = torch_params_from_flax(ckpt["params"])
    model = cfg_to_model(ckpt["cfg"])
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert len(sd) == len(flax_leaves) == len(want)
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # values carried over unchanged (up to the squeezed singleton axes)
    total = sum(float(np.abs(np.asarray(a, np.float64)).sum())
                for a in flax_leaves)
    assert sum(float(v.double().abs().sum()) for v in sd.values()) == \
        pytest.approx(total, rel=1e-12)
    model.load_state_dict(sd, strict=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
