"""The port's other model families against the flax models on the same
weights and inputs: UNeXT3D with relu / silu / selu, with layer scale 0,
with two input channels, and UNet3D (``bism_unet``); DropPath; one f32
train step of UNet3D, of relu and of DropPath with a fixed mask; and a
JAX-written ``bism_unet`` checkpoint through the port's ``run_inference``.
Tolerances are stated at each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.models.unext import ConvNeXtBlock3D as JaxBlock
from skoots_tpu.train.engine import cfg_optimizer as jax_cfg_optimizer
from skoots_tpu.train.engine import make_train_step as jax_make_train_step
from skoots_tpu.train.sigma import init_sigma as jax_init_sigma
from skoots_tpu_torch import config as C
from skoots_tpu_torch.checkpoint import flax_params_from_torch, torch_params_from_flax
from skoots_tpu_torch.models import cfg_to_model, init_model, load_flax_params
from skoots_tpu_torch.models import unext as U
from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step
from skoots_tpu_torch.train.sigma import init_sigma

T = torch.from_numpy

VARIANTS = {
    "relu": {"ACTIVATION": "relu"},
    "silu": {"ACTIVATION": "silu"},
    "selu": {"ACTIVATION": "selu"},
    "gamma0": {"LAYER_SCALE_INIT_VALUE": 0.0},
    "in2": {"IN_CHANNELS": 2},
    "unet": {"ARCHITECTURE": "bism_unet", "DIMS": [8, 16, 8], "OUT_CHANNELS": 8},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(model_update, dtype="float32"):
    """The same tiny model cfg in both packages (validation skipped: JAX's
    validator, like the port's, refuses IN_CHANNELS > 1, which both
    models build)."""
    m = {"DIMS": [4, 8, 4], "DEPTHS": [2, 1, 2], "OUT_CHANNELS": 4, "KERNEL_SIZE": 3,
         "DTYPE": dtype, **model_update}
    jc = jax_defaults()
    jc.defrost()
    for k, v in m.items():
        setattr(jc.MODEL, k, v)
    tc = C.get_cfg_defaults()
    tc["MODEL"].update(m)
    return jc, tc


def _random_params(params, rng, scale=0.2):
    """Random weights of a useful scale everywhere (init leaves norms and
    biases at 1/0, which would hide half the model)."""
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale, jnp.float32), params)


def _both_models(name, rng, dtype="float32", spatial=(16, 16, 8), head_gain=1.0):
    jc, tc = _cfgs(VARIANTS[name], dtype)
    jm, params = jax_init_model(jc, jax.random.PRNGKey(0), spatial=spatial)
    params = _random_params(params, rng)
    if head_gain != 1.0:  # logits spread around logit(0.8)
        for head in ("skeleton_head", "semantic_head"):
            leaf = params["params"][head]
            leaf["kernel"] = leaf["kernel"] * head_gain
            leaf["bias"] = jnp.full_like(leaf["bias"], np.log(4.0))
    tm = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, params))
    return jc, tc, jm, params, tm


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_matches_flax_f32(name, rng):
    """f32 throughout, sums in other orders: within 2e-5 (as the GELU
    model, tests/test_torch_model.py). The parameter trees match leaf for
    leaf (no ``gamma`` at layer scale 0; UNet3D's ``enc{s}_conv{i}``,
    ``enc{s}_gn{i}``, ``head_conv``), and the port's init fills the same
    leaves."""
    jc, tc, jm, params, tm = _both_models(name, rng)
    names = set(torch_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    assert names == set(tm.state_dict()) == set(init_model(tc, 3).state_dict())
    if name == "gamma0":
        assert not any(n.endswith("gamma") for n in names)
    if name == "unet":
        assert {"backbone.enc0_conv0.weight", "backbone.enc0_gn1.weight",
                "backbone.bottleneck_conv0.bias", "backbone.dec0_gn1.bias",
                "backbone.head_conv.weight"} <= names
    back = flax_params_from_torch(tm.state_dict())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                jax.tree_util.tree_flatten_with_path(back)[0]):
        assert pa == pb and np.asarray(a).shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)
    cin = jc.MODEL.IN_CHANNELS
    x = rng.standard_normal((1, 16, 16, 8, cin)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), deterministic=True))
    got = tm(T(x)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 8, 5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_unet_bf16_decisions_agree(rng):
    """UNet3D at bf16 on a random-weight model whose probability heads are
    scaled by 20 with their biases at logit(0.8), so that the threshold
    sits mid-distribution (the most sensitive case; a trained model's
    probabilities saturate). The port rounds where each flax operation
    rounds, up to the order of sums, and its output sigmoid rounds once
    where flax's rounds each step. JAX's own jitted and op-by-op forwards
    agree on only ~99.7% of the prob > 0.8 decisions here (XLA's fusion
    drops roundings), so the port is held to >= 99.5% against the op-by-op
    forward, and JAX's jit-vs-op-by-op agreement is checked to be below
    99.9% on the same model (a 99.9% bar would sit inside the reference's
    own spread)."""
    _, _, jm, params, tm = _both_models("unet", rng, dtype="bfloat16", head_gain=20.0)
    x = rng.standard_normal((1, 32, 32, 16, 1)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    jitted = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    got = tm(T(x)).numpy()
    assert np.isfinite(got).all()
    a, b, c = got[..., 3] > 0.8, want[..., 3] > 0.8, jitted[..., 3] > 0.8
    assert 0.05 * b.size < b.sum() < 0.95 * b.size
    assert float((a == b).mean()) >= 0.995, (int((a != b).sum()), a.size)
    assert float((c == b).mean()) < 0.999


# ------------------------------------------------------------------ DropPath

def _block_pair(rng, rate, dim=8, activation="gelu"):
    jb = JaxBlock(dim, 3, 1.0, rate, activation, jnp.float32)
    x = rng.standard_normal((8, 6, 6, 4, dim)).astype(np.float32)
    params = _random_params(jb.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tb = U.ConvNeXtBlock3D(dim, 3, 1.0, rate, activation, torch.float32)
    sd = {k.removeprefix("b."): v for k, v in
          torch_params_from_flax({"params": {"b": params["params"]}}).items()}
    tb.load_state_dict(sd, strict=True)
    return jb, params, tb, x


def test_droppath_is_identity_in_eval(rng):
    """A block with DropPath 0.5 in eval (or given no mask) equals the block
    without DropPath, through the fused tail, as JAX's with
    ``deterministic=True``; a model given a generator in eval draws no mask."""
    jb, params, tb, x = _block_pair(rng, 0.5)
    want = np.asarray(jb.apply(params, jnp.asarray(x), deterministic=True))
    np.testing.assert_allclose(tb.eval()(T(x)).detach().numpy(), want, atol=2e-5, rtol=0)
    jc, tc = _cfgs({"DROP_PATH_RATE": 0.5})
    m = init_model(tc, 1)
    xin = T(rng.standard_normal((2, 16, 16, 8, 1)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(m.eval()(xin, gen), m(xin))


def test_droppath_block_matches_jax_given_its_mask(rng):
    """JAX's block in training with DropPath 0.5 over a batch of 8: a
    dropped sample's output is its shortcut exactly, which reads JAX's keep
    mask off its output; the port's block given that mask matches within
    2e-5 (plain tail: LN, dense, GELU, dense, gamma, ``x / keep_prob``)."""
    jb, params, tb, x = _block_pair(rng, 0.5)
    for seed in range(20):
        want = np.asarray(jb.apply(params, jnp.asarray(x), deterministic=False,
                                   rngs={"droppath": jax.random.PRNGKey(seed)}))
        keep = np.array([not np.array_equal(want[b], x[b]) for b in range(len(x))])
        if 0 < keep.sum() < len(keep):
            break
    assert 0 < keep.sum() < len(keep)
    got = tb.train()(T(x), T(keep)).detach().numpy()
    np.testing.assert_array_equal(got[~keep], x[~keep])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_droppath_keep_rate_within_binomial_band():
    """2,000 draws at rate 0.1 from the training generator: the kept count
    lies within 4 standard deviations of 0.9 * 2,000."""
    m = U.UNeXT3D(1, 4, (4, 8, 4), (1, 1, 1), 3, drop_path_rate=0.1,
                  dtype=torch.float32).train()
    gen = torch.Generator().manual_seed(7)
    kept = sum(int(U._drop_keep(gen, m, 0.1, 1, "cpu")[0]) for _ in range(2000))
    n, p = 2000, 0.9
    assert abs(kept - n * p) <= 4 * np.sqrt(n * p * (1 - p)), kept
    assert U._drop_keep(gen, m.eval(), 0.1, 4, "cpu") is None
    assert U._drop_keep(None, m.train(), 0.1, 4, "cpu") is None


# -------------------------------------------------------------- train step

def _tiny_batch(b=2, shape=(16, 16, 8)):
    from skoots_tpu.utils.synthetic import make_tubes
    from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask

    img, lab, sk = make_tubes(shape, 2, radius=3, seed=9)
    packed = pack_skeletons(sk)
    baked = bake_skeleton(T(lab), packed, (1.0, 1.0, 3.0)).numpy()
    skel = skeleton_to_mask(packed, shape, 3, 3).numpy()
    one = {"image": ((img.astype(np.float32) - 60) / 30)[..., None],
           "masks": (lab > 0).astype(np.float32)[..., None], "baked": baked,
           "skele_masks": skel[..., None]}
    return {k: np.stack([v] * b) for k, v in one.items()}


# a fixed DropPath mask a block, in the order the blocks run
MASKS = [[True, False], [False, True], [True, True], [False, True], [True, False]]


@pytest.mark.parametrize("name", ["unet", "relu", "droppath"])
def test_one_f32_train_step_matches_jax(name, rng, monkeypatch):
    """JAX's initial weights in both, one f32 step's loss within 1e-5
    relative and every gradient leaf within 1e-3 * max|g_jax| (as the GELU
    model's step, tests/test_torch_train.py). DropPath 0.1 runs with the
    same fixed keep masks in both (JAX's bernoulli and the port's draw
    replaced by the list), since JAX's PRNG bits cannot be matched."""
    upd = {"droppath": {"DROP_PATH_RATE": 0.1}}.get(name, VARIANTS.get(name))
    jc, tc = _cfgs(upd)
    for c in (jc, tc):
        c["SKOOTS"]["VECTOR_SCALING"] = (8, 8, 4)
        c["TRAIN"]["LOSS_SKELETON_START_EPOCH"] = -1
    if name == "droppath":
        jmasks, tmasks = iter(MASKS), iter(MASKS)
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p, shape: jnp.asarray(next(jmasks)).reshape(shape))
        monkeypatch.setattr(U, "_drop_keep",
                            lambda gen, m, rate, b, dev: T(np.array(next(tmasks))))
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    opt, sched = jax_cfg_optimizer(jc)
    jstep = jax_make_train_step(jmodel, opt, sched, jax_init_sigma(jc), jc)
    batch = _tiny_batch()
    sig = jnp.asarray(jax_init_sigma(jc).host(0))
    (jloss, _), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0), sig,
        {"droppath": jax.random.PRNGKey(1)})

    model = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, jparams))
    model.train()
    topt, tsched = cfg_optimizer(tc, model.parameters())
    tstep = make_train_step(model, topt, tsched, init_sigma(tc), tc)
    total, _ = tstep.loss_fn({k: T(v) for k, v in batch.items()}, 0,
                             torch.Generator().manual_seed(0))
    total.backward()
    if name == "droppath":
        assert next(jmasks, None) is None and next(tmasks, None) is None  # all 5 used
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-5)
    tg = flax_params_from_torch({n: p.grad for n, p in model.named_parameters()})
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tg)[0])
    assert len(jflat) == len(tflat)
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in jflat)
    for path, jg in jflat:
        jg = np.asarray(jg)
        if np.abs(jg).max() <= 1e-6 * gmax:
            # a conv bias before a GroupNorm of one-channel groups: its
            # gradient is 0 in exact arithmetic, rounding noise in both
            assert np.abs(tflat[path]).max() <= 1e-6 * gmax, path
            continue
        np.testing.assert_allclose(tflat[path], jg, rtol=0,
                                   atol=1e-3 * np.abs(jg).max(), err_msg=str(path))


# --------------------------------------------------------------- inference

def test_jax_bism_unet_checkpoint_through_run_inference(tmp_path):
    """A JAX-written f32 ``bism_unet`` checkpoint (8-16-8, depth 1, 3^3,
    seeded init) on a 48x48x8 tube phantom at prob 0.5 (its skeleton
    probabilities stay below the default 0.8): the port's ``run_inference``
    on the CPU finds JAX's instance count (14), and each JAX instance's best
    match among the port's has IoU >= 0.95."""
    from skoots_tpu.infer.engine import run_inference as jax_run
    from skoots_tpu.train.checkpoint import save_checkpoint as jax_save
    from skoots_tpu.utils.io import imsave
    from skoots_tpu.utils.synthetic import make_tubes
    from skoots_tpu_torch.infer.engine import run_inference

    cfg = jax_defaults()
    cfg.merge_from_dict({"MODEL": {"ARCHITECTURE": "bism_unet", "DIMS": [8, 16, 8],
                                   "DEPTHS": [1, 1, 1], "OUT_CHANNELS": 8, "KERNEL_SIZE": 3,
                                   "DTYPE": "float32"},
                         "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}})
    _, params = jax_init_model(cfg, jax.random.PRNGKey(1), spatial=(16, 16, 8))
    ckpt = str(tmp_path / "unet.skoots")
    jax_save(ckpt, cfg, params, dataset_mean=100.0, dataset_std=50.0)
    img, _, _ = make_tubes(shape=(48, 48, 8), n_tubes=2, radius=3, seed=5)
    vol = str(tmp_path / "v.tif")
    imsave(vol, img)
    want = jax_run(vol, ckpt, prob_threshold=0.5, spatial_shards=0,
                   output_path=str(tmp_path / "j.tif"))
    got = run_inference(vol, ckpt, prob_threshold=0.5, device="cpu",
                        output_path=str(tmp_path / "t.tif"))
    ids = [i for i in np.unique(want) if i]
    assert len(ids) == 14 and len(np.unique(got)) - 1 == len(ids)
    for i in ids:
        a = want == i
        j, n = np.unique(got[a], return_counts=True)
        best = j[np.argmax(n)]
        assert best != 0
        b = got == best
        assert (a & b).sum() / (a | b).sum() >= 0.95, i
