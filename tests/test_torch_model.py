"""The port's model (``skoots_tpu_torch.models``) against the flax model on
the same weights (through the checkpoint bridge) and the same seeded input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.kernels.upsample import _xla_upsample
from skoots_tpu.models import cfg_to_model as jax_cfg_to_model
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from skoots_tpu.train.checkpoint import restore_params
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.models import cfg_to_model, load_flax_params, model_from_checkpoint
from skoots_tpu_torch.kernels.upsample import upsample2x_ref


def _tiny_f32():
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS = [4, 8, 4]
    cfg.MODEL.DEPTHS = [2, 1, 2]
    cfg.MODEL.OUT_CHANNELS = 8
    cfg.MODEL.DTYPE = "float32"
    cfg.freeze()
    return cfg


def test_tiny_f32_model_matches_flax(rng):
    cfg = _tiny_f32()
    model, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    # random weights of a useful scale everywhere (init leaves LN/bias at
    # 0/1 and gamma at 1e-6-ish, which would hide half the model)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.2, jnp.float32),
        params)
    tm = load_flax_params(cfg_to_model(cfg.to_dict()),
                          jax.tree_util.tree_map(np.asarray, params))
    x = rng.standard_normal((1, 16, 16, 8, 1)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x), deterministic=True))
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 8, 5)
    # f32 throughout; sums in other orders (7^3 taps, LN, matmuls)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_matches_xla_path(rng, dtype):
    x = rng.standard_normal((1, 6, 5, 4, 8)).astype(np.float32)
    want = np.asarray(_xla_upsample(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = upsample2x_ref(torch.from_numpy(x).to(getattr(torch, dtype)))
    # the same f32 cascade and one rounding: exact
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bench_checkpoint_decisions_agree_at_bf16():
    """Full width (32-64-128, 7^3, bf16) on a 32^3 tube tile: the port
    rounds where the TPU kernels round, the flax model on the CPU where XLA
    does, so values differ by bf16 ulps; the thresholded decisions that
    drive the pipeline must agree on >= 99.9% of voxels."""
    ck = jax_load_checkpoint("runs/bench_ckpt.skoots")
    jm = jax_cfg_to_model(ck["cfg"])
    tmpl = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 16, 1)),
        deterministic=True))
    jparams = restore_params(tmpl, ck["params"])
    tck = load_checkpoint("runs/bench_ckpt.skoots")
    tm = model_from_checkpoint(tck)
    assert tck["cfg"]["MODEL"]["DTYPE"] == "bfloat16"

    img, _, _ = make_tubes(shape=(32, 32, 32), n_tubes=3, seed=5)
    x = ((img.astype(np.float32) - tck["dataset_mean"])
         / tck["dataset_std"])[None, ..., None]
    want = np.asarray(jm.apply(jparams, jnp.asarray(x), deterministic=True))
    got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    for ch, name in ((3, "skeleton"), (4, "semantic")):
        a, b = got[..., ch] > 0.8, want[..., ch] > 0.8
        agree = float((a == b).mean())
        print(f"{name} prob>0.8: agree {agree:.6f}, {int((a != b).sum())} of "
              f"{a.size} voxels differ ({int(a.sum())} vs {int(b.sum())} set); "
              f"max |d| {np.abs(got[..., ch] - want[..., ch]).max():.4g}")
        assert b.sum() > 100  # the tubes are found at all
        assert agree >= 0.999
