"""Sparse training's pieces (``skoots_tpu_torch/experimental``) against
the JAX package on the CPU: the modifiers and autoknobs, the bake's
options, the augmentation's aux volume, the loss and its parts, the
dataset's samples, one f32 step's loss and gradients and the non-finite
guard (the loop, SWA and the CLI: tests/test_torch_sparse_train.py)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.experimental import data as JXD
from skoots_tpu.experimental import modifiers as JXM
from skoots_tpu.experimental import sparse_engine as JXE
from skoots_tpu.experimental import sparse_loss as JXL
from skoots_tpu.infer import autoknobs as JK
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.models import split_output
from skoots_tpu.ops.skeleton import bake_skeleton as jax_bake
from skoots_tpu.ops.skeleton import pack_skeletons as jax_pack
from skoots_tpu.ops.vec2embed import vector_to_embedding as jax_v2e
from skoots_tpu.train import transforms as JT
from skoots_tpu.train.engine import TrainState as JaxTrainState
from skoots_tpu.train.engine import cfg_optimizer as jax_cfg_optimizer
from skoots_tpu.train.generate_skeletons import save_skeletons as jax_save_skeletons
from skoots_tpu.train.losses import cfg_loss as jax_cfg_loss
from skoots_tpu.train.sigma import init_sigma as jax_init_sigma
from skoots_tpu.utils.io import imsave
from skoots_tpu.utils.synthetic import make_tubes as jax_make_tubes
from skoots_tpu_torch import config as C
from skoots_tpu_torch.checkpoint import flax_params_from_torch
from skoots_tpu_torch.experimental import data as XD
from skoots_tpu_torch.experimental import modifiers as XM
from skoots_tpu_torch.experimental import sparse_engine as XE
from skoots_tpu_torch.experimental import sparse_loss as XL
from skoots_tpu_torch.infer import autoknobs as K
from skoots_tpu_torch.models import cfg_to_model, load_flax_params
from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons
from skoots_tpu_torch.train import transforms as TT
from skoots_tpu_torch.train.engine import cfg_optimizer
from skoots_tpu_torch.train.sigma import init_sigma

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
    tube) and skeleton points; no skeleton stamp files (painted)."""
    d = tmp_path_factory.mktemp("sparse_data")
    for i in range(2):
        img, labels, skels = jax_make_tubes(shape=(64, 64, 8), n_tubes=2, seed=i)
        imsave(str(d / f"v{i}.tif"), img)
        imsave(str(d / f"v{i}.background.tif"),
               (ndimage.distance_transform_edt(labels == 0) > 6).astype(np.uint8))
        jax_save_skeletons(str(d / f"v{i}.skeletons.npz"), skels)
    return str(d)


# ---------------------------------------------------------------- pieces

def test_modifiers_match_jax(rng):
    bg = (rng.random((12, 10, 9)) > 0.3).astype(np.float32)
    for n in (0, 1, 2):
        np.testing.assert_array_equal(XM.erode_bg_masks(bg, n), JXM.erode_bg_masks(bg, n))
    for alpha in (0.34, 0.5, 1.0):
        np.testing.assert_array_equal(XM.ablate_bg_masks(bg, alpha),
                                      JXM.ablate_bg_masks(bg, alpha))
    with pytest.raises(ValueError):
        XM.ablate_bg_masks(bg, 0.0)


def test_sparse_autoknobs_match_jax(rng):
    skels = {1: rng.random((40, 3)) * 20, 2: rng.random((30, 3)) * 20 + 15,
             3: rng.random((5, 3)) * 30}
    assert K.suggest_dist_thr_from_points(skels) == JK.suggest_dist_thr_from_points(skels)
    assert K.suggest_dist_thr_from_points({1: skels[1]}) is None
    for aniso in ((1.0, 1.0, 1.0), (1.0, 1.0, 3.0)):
        assert (K.sparse_target_fg_fraction(skels, (32, 32, 16), 4.0, aniso)
                == JK.sparse_target_fg_fraction(skels, (32, 32, 16), 4.0, aniso))
    assert K.sparse_target_fg_fraction({}, (8, 8, 8), 4.0) is None
    probs = rng.random(5000).astype(np.float32)
    for frac in (1e-9, 0.01, 0.3, 0.95):
        assert (K.calibrate_semantic_threshold(probs, frac)
                == JK.calibrate_semantic_threshold(probs, frac))


def test_bake_average_and_distance_match_jax(rng):
    """``average`` and ``return_distance`` as JAX's ``bake_skeleton``, to
    the bake tests' 1e-3 (tests/test_torch_train_kernels.py)."""
    masks = np.zeros((16, 12, 8), np.int32)
    masks[2:9, 1:10, 1:7] = 1
    masks[9:15, 3:12, 2:8] = 2
    skels = {1: (rng.random((6, 3)) * [7, 9, 6] + [2, 1, 1]).astype(np.float32),
             2: (rng.random((5, 3)) * [6, 9, 6] + [9, 3, 2]).astype(np.float32)}
    for average in (True, False):
        want_b, want_d = jax_bake(jnp.asarray(masks), jax_pack(skels), (1.0, 1.0, 3.0),
                                  average=average, return_distance=True)
        got_b, got_d = bake_skeleton(T(masks), pack_skeletons(skels), (1.0, 1.0, 3.0),
                                     average=average, return_distance=True)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-3)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-3)
    only = bake_skeleton(T(masks), pack_skeletons(skels), (1.0, 1.0, 3.0), average=False)
    np.testing.assert_array_equal(only.numpy(), got_b.numpy())


def test_geometric_core_threads_aux_as_jax():
    """A deterministic cfg (every rate 0 or 1): the aux volume follows the
    masks through the affine, crop and flips, nearest-interpolated, as
    JAX's; picks may differ where the affine's f32 inverse moves an order-0
    pick at a .5 boundary (<= 0.1% of voxels, as the masks'). Without aux
    the core returns None in its place."""
    upd = {"AUGMENTATION": {
        "CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8, "ELASTIC_RATE": 0.0,
        "NOISE_RATE": 0.0, "AFFINE_RATE": 1.0, "AFFINE_YAW": [30, 30],
        "AFFINE_SHEAR": [4, 4], "AFFINE_SCALE": [1.05, 1.05], "FLIP_RATE": 1.0,
        "INVERT_RATE": 0.0, "BRIGHTNESS_RATE": 0.0, "CONTRAST_RATE": 0.0}}
    jc, tc = _both_cfgs(upd)
    img, lab, sk = jax_make_tubes((48, 48, 8), 3, radius=4, seed=2)
    aux = (ndimage.distance_transform_edt(lab == 0) <= 1).astype(np.float32)
    pts = np.concatenate(list(sk.values()))[:64].astype(np.float32)
    ids = np.concatenate([np.full(len(v), k, np.int32) for k, v in sk.items()])[:64]
    sample = {"image": img.astype(np.float32), "masks": lab.astype(np.int32), "aux": aux,
              "points": pts, "ids": ids, "center": sk[1].mean(0).astype(np.float32)}
    want = JT.make_augment(jc, 60.0, 30.0).geometric_core(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in sample.items()})
    got = TT.make_augment(tc, 60.0, 30.0).geometric_core(
        {k: T(v) for k, v in sample.items()}, torch.Generator().manual_seed(0))
    for name, g, w in zip(("masks", "aux"), got[1:3], want[1:3]):
        assert g.shape == w.shape
        differ = g.numpy() != np.asarray(w)
        assert differ.mean() <= 1e-3, (name, differ.sum())
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-3)
    del sample["aux"]
    assert TT.make_augment(tc).geometric_core(
        {k: T(v) for k, v in sample.items()}, torch.Generator().manual_seed(0))[2] is None


def test_vector_direction_penalty_matches_jax(rng):
    v = rng.standard_normal((2, 9, 7, 5, 3)).astype(np.float32)
    v[0, 3] = 0.0  # zero vectors never count as neighbours
    want = np.asarray(JXL.vector_direction_penalty(jnp.asarray(v)))
    got = XL.vector_direction_penalty(T(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _loss_inputs(rng, case):
    b, shape, p = 2, (16, 16, 8), 64
    embed = (rng.random((b, *shape, 3)) * [16, 16, 8]).astype(np.float32)
    vectors = rng.standard_normal((b, *shape, 3)).astype(np.float32)
    points = (rng.random((b, p, 3)) * [16, 16, 8]).astype(np.float32)
    valid = rng.random((b, p)) > 0.3
    background = (rng.random((b, *shape, 1)) > 0.7).astype(np.float32)
    semantic = rng.random((b, *shape, 1)).astype(np.float32)
    if case == "no_points":
        valid[1] = False
    if case == "single_voxel":  # every voxel certain background
        background[:] = 1.0
    return embed, vectors, points, valid, background, semantic


@pytest.mark.parametrize("case", ["points", "no_points", "single_voxel"])
def test_sparse_loss_matches_jax(rng, case):
    """B = 2, 16x16x8, P = 64: background loss, embed loss and probability
    within 1e-5 relative."""
    args = _loss_inputs(rng, case)
    kw = dict(sigma=np.asarray([2.0, 2.0, 1.5], np.float32), anisotropy=(1.0, 1.0, 3.0),
              distance_thr=3.0, bg_multiplier=10.0)
    want = JXL.sparse_loss(*map(jnp.asarray, args[:3]), jnp.asarray(args[3]),
                           *map(jnp.asarray, args[4:]), **kw)
    got = XL.sparse_loss(*map(T, args[:3]), T(args[3]), *map(T, args[4:]), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    if case == "no_points":  # the fallbacks: baked 1000 and dist 100
        baked, dist = XL.closest_skeleton(T(args[2][1]), T(args[3][1]), (16, 16, 8),
                                          (1.0, 1.0, 3.0))
        assert float(baked.min()) == 1000.0 and float(dist.min()) == 100.0


@pytest.mark.parametrize("modifier", [{}, {"BACKGROUND_N_ERODE": 1.0},
                                      {"BACKGROUND_SLICE_PERCENTAGE": 0.5}],
                         ids=["plain", "erode", "ablate"])
def test_sparse_dataset_sample_matches_jax(sparse_dir, modifier):
    """Same directory, cfg and ``Generator``: the same arrays, with and
    without the background ablations; the in-memory records give the same
    samples as the directory."""
    jc, tc = _both_cfgs(_merge(TINY, {"EXPERIMENTAL": modifier}))
    jd, td = JXD.SparseDataset(sparse_dir, jc), XD.SparseDataset(sparse_dir, tc)
    mem = XD.SparseDataset([XD.SparseRecord(r.image, r.background, None, r.skeletons, r.name)
                            for r in XD.SparseDataset(sparse_dir, C.merge_from_dict(
                                C.get_cfg_defaults(), TINY)).records], tc)
    assert len(jd) == len(td) == 2
    rj, rt, rm = (np.random.default_rng(5) for _ in range(3))
    for _ in range(4):
        a, b, c = jd.sample(rj), td.sample(rt), mem.sample(rm)
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(c[k], b[k], err_msg=k)


# ------------------------------------------------------------ train step

def _sparse_batch():
    """A B = 2 batch at 16x16x8, as the sparse augmentation outputs it."""
    img, lab, sk = jax_make_tubes((16, 16, 8), 2, radius=3, seed=9)
    pts = np.zeros((64, 3), np.float32)
    ids = np.zeros(64, np.int32)
    allp = np.concatenate(list(sk.values()))[:64]
    pts[:len(allp)] = allp
    ids[:len(allp)] = 1
    bg = (ndimage.distance_transform_edt(lab == 0) > 3).astype(np.float32)
    one = {"image": ((img.astype(np.float32) - 60) / 30)[..., None],
           "background": bg[..., None],
           "skele_masks": (ndimage.distance_transform_edt(lab == 0) == 0).astype(
               np.float32)[..., None],
           "points": pts, "valid": ids != 0}
    batch = {k: np.stack([v] * 2) for k, v in one.items()}
    batch["valid"][1, 10:] = False
    return batch


def _jax_loss_fn(jmodel, jc, epoch):
    """The JAX sparse step's loss, from JAX's public pieces."""
    vs = jnp.asarray(jc.SKOOTS.VECTOR_SCALING, jnp.float32)
    t, x = jc.TRAIN, jc.EXPERIMENTAL
    loss_skele = jax_cfg_loss(t.LOSS_SKELETON, t.LOSS_SKELETON_KEYWORDS, t.LOSS_SKELETON_VALUES)
    sigma = jnp.asarray(jax_init_sigma(jc).host(epoch))

    def loss(params, batch):
        vec, skel, prob = split_output(jmodel.apply(params, batch["image"], deterministic=True))
        l_bg, l_embed, _ = JXL.sparse_loss(
            embed=jax_v2e(vs, vec), vectors=vec * vs.reshape(1, 1, 1, 1, 3),
            points=batch["points"], valid=batch["valid"], background=batch["background"],
            semantic=prob, sigma=sigma, anisotropy=tuple(jc.AUGMENTATION.BAKE_SKELETON_ANISOTROPY),
            distance_thr=x.DIST_THR, bg_multiplier=x.SPARSE_BACKGROUND_PENALTY_MULTIPLIER)
        l_skel = loss_skele(skel, (batch["skele_masks"] > 0).astype(jnp.float32))
        g = [float(epoch > e0) for e0 in (t.LOSS_EMBED_START_EPOCH,
                                           t.LOSS_PROBABILITY_START_EPOCH,
                                           t.LOSS_SKELETON_START_EPOCH)]
        return (t.LOSS_EMBED_RELATIVE_WEIGHT * g[0] * l_embed
                + t.LOSS_PROBABILITY_RELATIVE_WEIGHT * g[1] * l_bg
                + t.LOSS_SKELETON_RELATIVE_WEIGHT * g[2] * l_skel)

    return loss


def _tiny_models():
    jc, tc = _both_cfgs(TINY)
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jc, tc, jmodel, jparams


def _port_step(tc, jparams):
    model = load_flax_params(cfg_to_model(tc), jparams).train()
    opt, sched = cfg_optimizer(tc, model.parameters())
    return model, opt, XE.make_sparse_train_step(model, opt, sched, init_sigma(tc), tc)


def test_one_f32_sparse_step_matches_jax():
    """From JAX's initial weights, augmentation off: the loss within 1e-5
    relative and every gradient leaf within 1e-3 * max|g_jax|."""
    jc, tc, jmodel, jparams = _tiny_models()
    batch = _sparse_batch()
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jmodel, jc, 0))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model, _, step = _port_step(tc, jparams)
    total, metrics = step.loss_fn({k: T(v) for k, v in batch.items()}, 0)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-5)
    tg = flax_params_from_torch({n: p.grad for n, p in model.named_parameters()})
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tg)[0])
    assert len(jflat) == len(tflat)
    for path, jg in jflat:
        jg = np.asarray(jg)
        np.testing.assert_allclose(tflat[path], jg, rtol=0, atol=1e-3 * np.abs(jg).max(),
                                   err_msg=str(path))


def test_nonfinite_loss_skips_the_whole_update():
    """A NaN batch, then a finite one. JAX guards only the parameters and
    keeps the poisoned optimizer state, so the finite step writes NaN into
    its parameters. The port skips parameters, optimizer state and the
    optimizer's step count: its parameters equal a run that never saw the
    NaN batch."""
    jc, tc, jmodel, jparams = _tiny_models()
    batch = _sparse_batch()
    nan_batch = dict(batch, image=np.full_like(batch["image"], np.nan))
    opt, sched = jax_cfg_optimizer(jc)
    jstep = JXE.make_sparse_train_step(jmodel, opt, sched, jax_init_sigma(jc), jc)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=opt.init(params))
    for b in (nan_batch, batch):
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in b.items()}, 0)
    assert int(state.step) == 2
    assert not all(bool(jnp.all(jnp.isfinite(p)))
                   for p in jax.tree_util.tree_leaves(state.params))

    model, topt, step = _port_step(tc, jparams)
    m = step({k: T(v) for k, v in nan_batch.items()}, 0)
    assert m["skipped"] and not np.isfinite(float(m["loss"]))
    assert len(topt.state) == 0  # no moments, no step count
    assert not step({k: T(v) for k, v in batch.items()}, 0)["skipped"]
    assert {int(s["step"]) for s in topt.state.values()} == {1}
    ref_model, _, ref_step = _port_step(tc, jparams)
    ref_step({k: T(v) for k, v in batch.items()}, 0)
    for (name, p), q in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.isfinite(p).all(), name
        assert torch.equal(p, q), name
