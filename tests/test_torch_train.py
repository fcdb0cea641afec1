"""The port's training path (``skoots_tpu_torch.train``, ``config``,
``checkpoint`` save, model init) against the JAX package on the same seeded
inputs and weights: the augmentation with a deterministic cfg, the host
batches, one f32 train step, the optimizer, the config, checkpoints in
both directions, and ``python -m skoots_tpu_torch.train`` end to end.
Tolerances are stated at each comparison."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.infer.autoknobs import estimate_object_radius as jax_radius
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.train import data as JD
from skoots_tpu.train import transforms as JT
from skoots_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from skoots_tpu.train.checkpoint import restore_params
from skoots_tpu.train.engine import _warm_restart_schedule
from skoots_tpu.train.engine import cfg_optimizer as jax_cfg_optimizer
from skoots_tpu.train.engine import make_train_step as jax_make_train_step
from skoots_tpu.train.generate_skeletons import load_skeletons as jax_load_skeletons
from skoots_tpu.train.generate_skeletons import save_skeletons as jax_save_skeletons
from skoots_tpu.train.sigma import init_sigma as jax_init_sigma
from skoots_tpu.utils.io import imsave
from skoots_tpu.utils.synthetic import make_tubes as jax_make_tubes
from skoots_tpu_torch import config as C
from skoots_tpu_torch.checkpoint import (
    flax_params_from_torch,
    load_checkpoint,
    msgpack_decode,
    msgpack_encode,
    save_checkpoint,
    torch_params_from_flax,
)
from skoots_tpu_torch.infer.autoknobs import estimate_object_radius
from skoots_tpu_torch.models import cfg_to_model, init_model, load_flax_params
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.train import data as TD
from skoots_tpu_torch.train import transforms as TT
from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step, warm_restart_lr
from skoots_tpu_torch.train.generate_skeletons import load_skeletons, save_skeletons
from skoots_tpu_torch.train.sigma import init_sigma
from skoots_tpu_torch.utils.synthetic import make_tubes

T = torch.from_numpy

TINY_MODEL = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
              "KERNEL_SIZE": 3, "DTYPE": "float32"}


def _both_cfgs(update):
    """The same settings in both packages' cfg objects."""
    jc = jax_defaults()
    jc.merge_from_dict(update)
    return jc, C.merge_from_dict(C.get_cfg_defaults(), update)


# ------------------------------------------------------------------ config

def test_config_defaults_strict_and_lenient_merge(tmp_path):
    assert C.to_plain(C.get_cfg_defaults()) == C.to_plain(jax_defaults().to_dict())
    with pytest.raises(KeyError):
        C.merge_from_dict(C.get_cfg_defaults(), {"TRAIN": {"NOT_A_KEY": 1}})
    with pytest.raises(TypeError):
        C.merge_from_dict(C.get_cfg_defaults(), {"TRAIN": 3})
    p = tmp_path / "c.yaml"
    p.write_text(yaml.safe_dump({"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}}))
    cfg = C.load_cfg_from_file(str(p))
    assert cfg["MODEL"]["DIMS"] == [4, 8, 16, 8, 4]
    assert cfg["SKOOTS"]["VECTOR_SCALING"] == (8, 8, 4)  # list -> tuple, as JAX
    p.write_text(yaml.safe_dump({"MODEL": {"OUT_CHANNELS": 7}}))
    with pytest.raises(ValueError):  # OUT_CHANNELS != DIMS[-1]
        C.load_cfg_from_file(str(p))
    lenient = C.cfg_from_dict({"TRAIN": {"FUTURE_KEY": 2, "SEED": 3}})
    assert lenient["TRAIN"]["FUTURE_KEY"] == 2 and lenient["TRAIN"]["SEED"] == 3


# -------------------------------------------------------- init, checkpoint

def _jax_tiny(spatial=(16, 16, 8)):
    jc, tc = _both_cfgs({"MODEL": TINY_MODEL})
    model, params = jax_init_model(jc, jax.random.PRNGKey(0), spatial=spatial)
    return jc, tc, model, jax.tree_util.tree_map(np.asarray, params)


def test_init_follows_flax_initialisers():
    """Same parameter set and shapes as flax's init; LayerNorm scales 1,
    biases 0, gamma the layer-scale value exactly; every kernel a
    truncated normal of variance 1 / fan_in (flax's fan-in rule), checked
    by its standard deviation over the whole bench-width model."""
    _, tc, _, jparams = _jax_tiny()
    want = torch_params_from_flax(jparams)
    got = init_model(tc, 7).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k, v in got.items():
        if k.endswith("bias") or k.endswith("gamma") or ".norm." in k or "final_norm" in k:
            assert torch.equal(v, want[k]), k
    wide = init_model(C.get_cfg_defaults(), 7).state_dict()
    for k, v in wide.items():
        if k.endswith("weight") and v.ndim >= 2:
            fan_in = int(np.prod(v.shape[:-1]))
            std = float(v.std())
            assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1 + 3 / np.sqrt(v.numel()), k
            assert float(v.abs().max()) <= 2.0 / 0.8796 / np.sqrt(fan_in) + 1e-6, k
    cfg = C.get_cfg_defaults()  # DropPath builds, and adds no parameter (as in flax)
    cfg["MODEL"]["DROP_PATH_RATE"] = 0.1
    assert cfg_to_model(cfg).state_dict().keys() == wide.keys()


def test_msgpack_encoder_writes_flax_bytes(rng):
    """The port's encoder writes the bytes flax writes for the same state,
    and the port's decoder reads them back."""
    state = {"cfg": {"A": [1, 2.5, "x" * 40, None, True], "B": {"C": -7, "D": 70000}},
             "params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "s": np.float32(2.0)},
             "opt_state": None, "dataset_mean": 1.5, "extra": {"epoch": 3}}
    blob = msgpack_encode(state)
    assert blob == serialization.msgpack_serialize(state)
    back = msgpack_decode(blob)
    np.testing.assert_array_equal(back["params"]["w"], state["params"]["w"])
    assert back["cfg"] == state["cfg"] and back["extra"] == {"epoch": 3}


def test_checkpoints_load_in_both_packages(tmp_path, rng):
    """flax -> torch -> flax is the identity on the parameter tree; a
    checkpoint the port writes loads in the JAX package's
    ``load_checkpoint`` + ``restore_params`` and back in the port."""
    jc, tc, model, jparams = _jax_tiny()
    sd = torch_params_from_flax(jparams)
    back = flax_params_from_torch(sd)
    flat = lambda t: {"/".join(map(str, k)): v for k, v in  # noqa: E731
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(jparams), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    path = str(tmp_path / "m.skoots")
    save_checkpoint(path, tc, sd, dataset_mean=40.0, dataset_std=12.5,
                    extra={"epoch": 2, "object_radius": None})
    ck = jax_load_checkpoint(path)
    restored = restore_params(jparams, ck["params"])
    for k, v in flat(restored).items():
        np.testing.assert_array_equal(np.asarray(v), a[k])
    assert ck["cfg"].MODEL.DIMS == [4, 8, 16, 8, 4] and ck["dataset_std"] == 12.5
    assert ck["opt_state"] is None and ck["extra"]["epoch"] == 2
    tck = load_checkpoint(path)
    m = model_from_checkpoint(tck)
    assert all(torch.equal(m.state_dict()[k], v) for k, v in sd.items())


# -------------------------------------------------------------- host data

def test_make_tubes_skeleton_files_and_radius_match_jax(tmp_path):
    img, lab, sk = make_tubes((48, 40, 8), 3, radius=3, seed=4)
    jimg, jlab, jsk = jax_make_tubes((48, 40, 8), 3, radius=3, seed=4)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(lab, jlab)
    assert sk.keys() == jsk.keys()
    save_skeletons(str(tmp_path / "a.skeletons.npz"), sk)
    loaded = jax_load_skeletons(str(tmp_path / "a.skeletons.npz"))
    jax_save_skeletons(str(tmp_path / "b.skeletons.npz"), jsk)
    for k in sk:
        np.testing.assert_array_equal(sk[k], jsk[k])
        np.testing.assert_array_equal(loaded[k], sk[k])
        np.testing.assert_array_equal(load_skeletons(str(tmp_path / "b.skeletons.npz"))[k], sk[k])
    assert estimate_object_radius(lab, sk) == jax_radius(lab, sk)
    assert estimate_object_radius(lab) == jax_radius(lab)


@pytest.fixture(scope="module")
def tif_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_data")
    for i in range(2):
        image, labels, skels = jax_make_tubes(shape=(64, 64, 8), n_tubes=2, seed=i)
        imsave(str(d / f"vol{i}.tif"), image)
        imsave(str(d / f"vol{i}.labels.tif"), labels)
        jax_save_skeletons(str(d / f"vol{i}.skeletons.npz"), skels)
    return str(d)


def test_batch_iterator_matches_jax(tif_dir):
    """Same files, cfg and seed: bit-identical host batches, statistics,
    ceiling and object radius."""
    upd = {"TRAIN": {"MAX_SKELETON_POINTS": 64},
           "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8}}
    jc, tc = _both_cfgs(upd)
    jd = JD.MultiDataset([JD.SkootsDataset(tif_dir, jc, sample_per_image=3)])
    td = TD.MultiDataset([TD.SkootsDataset(tif_dir, tc, sample_per_image=3)])
    assert len(jd) == len(td) == 6
    assert td.mean_std(True) == jd.mean_std(True)
    assert td.intensity_ceiling() == jd.intensity_ceiling()
    assert td.object_radius() == jd.object_radius()
    ji, ti = JD.batch_iterator(jd, 2, 3, 11), TD.batch_iterator(td, 2, 3, 11)
    for epoch in (0, 1):
        jb, tb = list(ji(epoch)), list(TD.prefetch_iterator(ti)(epoch))
        assert len(jb) == len(tb) == 3
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ augmentation

def test_warp_volume_and_elastic_field_match_jax(rng):
    vol = rng.random((12, 10, 6)).astype(np.float32) * 255
    disp = (rng.standard_normal((12, 10, 6, 3)) * 2).astype(np.float32)
    disp[0, 0, 0] = [0.5, -0.5, 1.5]  # half-way: order 0 rounds away from zero
    for order in (0, 1):
        want = np.asarray(JT._warp_volume(jnp.asarray(vol), jnp.asarray(disp), order))
        got = TT._warp_volume(T(vol), T(disp), order).numpy()
        if order == 0:
            np.testing.assert_array_equal(got, want)  # the same picks
        else:  # XLA may fuse the corner products into FMAs
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    coarse = rng.random((6, 6, 2, 3)).astype(np.float32) * 5
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (40, 36, 8, 3), "trilinear"))
    got = torch.nn.functional.interpolate(
        T(coarse).permute(3, 0, 1, 2)[None], size=(40, 36, 8), mode="trilinear",
        align_corners=False)[0].permute(1, 2, 3, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    pts = (rng.random((20, 3)) * [40, 36, 8]).astype(np.float32)
    want = np.asarray(JT._sample_disp_at_points(jnp.asarray(coarse), jnp.asarray(pts),
                                                (40, 36, 8)))
    got = TT._sample_disp_at_points(T(coarse), T(pts), (40, 36, 8)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


DETERMINISTIC = {
    "AUGMENTATION": {
        "CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8,
        "ELASTIC_RATE": 0.0, "NOISE_RATE": 0.0, "AFFINE_RATE": 1.0,
        "AFFINE_YAW": [30, 30], "AFFINE_SHEAR": [4, 4], "AFFINE_SCALE": [1.05, 1.05],
        "FLIP_RATE": 1.0, "INVERT_RATE": 1.0, "BRIGHTNESS_RATE": 1.0,
        "BRIGHTNESS_RANGE": [6.0, 6.0], "CONTRAST_RATE": 1.0, "CONTRAST_RANGE": [1.3, 1.3],
    },
    "TRAIN": {"SKELETON_MASK_RADIUS": 3, "MAX_SKELETON_POINTS": 128},
}


def test_make_augment_matches_jax_deterministic_cfg():
    """Every draw deterministic (rates 0 or 1, degenerate ranges): image
    within 1e-3 of its 0-255 range, masks differing on <= 0.1% of voxels
    (the affine's f32 inverse can move an order-0 pick at a .5 boundary),
    the skeleton mask exact, the baked field where the masks agree."""
    jc, tc = _both_cfgs(DETERMINISTIC)
    img, lab, sk = jax_make_tubes((48, 48, 8), 3, radius=4, seed=2)
    pts = np.zeros((128, 3), np.float32)
    ids = np.zeros(128, np.int32)
    allp = np.concatenate(list(sk.values()))[:128]
    alli = np.concatenate([np.full(len(v), k, np.int32) for k, v in sk.items()])[:128]
    pts[:len(allp)], ids[:len(alli)] = allp, alli
    sample = {"image": img.astype(np.float32), "masks": lab.astype(np.int32),
              "points": pts, "ids": ids, "center": sk[1].mean(0).astype(np.float32)}
    mean, std = 60.0, 30.0
    want = JT.make_augment(jc, mean, std)(jax.random.PRNGKey(0),
                                          {k: jnp.asarray(v) for k, v in sample.items()})
    want = {k: np.asarray(v) for k, v in want.items()}
    got = TT.make_augment(tc, mean, std)({k: T(v) for k, v in sample.items()},
                                         torch.Generator().manual_seed(0))
    got = {k: v.numpy() for k, v in got.items()}
    assert all(got[k].shape == want[k].shape for k in want)
    np.testing.assert_allclose(got["image"] * std, want["image"] * std, atol=1e-3 * 255)
    differ = got["masks"] != want["masks"]
    assert differ.mean() <= 1e-3, differ.sum()
    np.testing.assert_array_equal(got["skele_masks"], want["skele_masks"])
    # the baked field averages a 3^3 window: compare where the masks agree
    # on the whole window, to the bake tests' 1e-3
    win = torch.nn.functional.max_pool3d(T(differ[..., 0].astype(np.float32))[None, None],
                                         3, 1, 1)[0, 0].numpy() == 0
    close = np.abs(got["baked"] - want["baked"]).max(-1) <= 1e-3
    assert close[win].mean() >= 0.999, (~close[win]).sum()


# ------------------------------------------------------------- train step

def _tiny_batch(b=1, shape=(16, 16, 8)):
    img, lab, sk = jax_make_tubes(shape, 2, radius=3, seed=9)
    from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask

    packed = pack_skeletons(sk)
    baked = bake_skeleton(T(lab), packed, (1.0, 1.0, 3.0)).numpy()
    skel = skeleton_to_mask(packed, shape, 3, 3).numpy()
    one = {"image": ((img.astype(np.float32) - 60) / 30)[..., None],
           "masks": (lab > 0).astype(np.float32)[..., None], "baked": baked,
           "skele_masks": skel[..., None]}
    return {k: np.stack([v] * b) for k, v in one.items()}


def test_one_f32_train_step_matches_jax():
    """The tiny config of tests/test_train_step.py at f32, JAX's initial
    weights in both: the loss within 1e-5 relative and every gradient leaf
    within 1e-3 * max|g_jax| (sums in another order; JAX's flax LayerNorm
    uses the fast variance, the port's block tail the two-pass one)."""
    jc, tc = _both_cfgs({"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
                         "TRAIN": {"LOSS_SKELETON_START_EPOCH": -1}})
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    opt, sched = jax_cfg_optimizer(jc)
    jstep = jax_make_train_step(jmodel, opt, sched, jax_init_sigma(jc), jc)
    batch = _tiny_batch(b=2)
    sig = jnp.asarray(jax_init_sigma(jc).host(0))
    (jloss, _), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0), sig,
        {"droppath": jax.random.PRNGKey(1)})

    model = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, jparams))
    model.train()
    topt, tsched = cfg_optimizer(tc, model.parameters())
    tstep = make_train_step(model, topt, tsched, init_sigma(tc), tc)
    total, _ = tstep.loss_fn({k: T(v) for k, v in batch.items()}, 0)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-5)
    tg = flax_params_from_torch({n: p.grad for n, p in model.named_parameters()})
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tg)[0])
    assert len(jflat) == len(tflat)
    for path, jg in jflat:
        jg = np.asarray(jg)
        np.testing.assert_allclose(tflat[path], jg, rtol=0,
                                   atol=1e-3 * np.abs(jg).max(), err_msg=str(path))


def test_optimizer_and_schedule_match_optax(rng):
    """AdamW on identical gradients with the per-epoch warm-restart lr:
    parameters within 1e-6 relative of optax's after each step (optax
    decays every leaf, as one torch parameter group does)."""
    upd = {"TRAIN": {"LEARNING_RATE": 1e-2, "WEIGHT_DECAY": 1e-2, "SCHEDULER_T0": 3}}
    jc, tc = _both_cfgs(upd)
    sched = _warm_restart_schedule(1e-2, 3)
    for e in range(8):
        np.testing.assert_allclose(warm_restart_lr(1e-2, 3, e), float(sched(e)), rtol=1e-6)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]
    opt, jsched = jax_cfg_optimizer(jc)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in p0.items()}
    topt, tsched = cfg_optimizer(tc, list(tp.values()))
    import optax

    for e, g in enumerate(grads):
        state.hyperparams["learning_rate"] = jnp.asarray(np.float32(jsched(e)))
        upd_, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd_)
        for k, p in tp.items():
            p.grad = T(g[k])
        for group in topt.param_groups:
            group["lr"] = tsched(e)
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)


# --------------------------------------------------------------------- CLI

def test_train_cli_end_to_end(tif_dir, tmp_path, caplog, monkeypatch):
    """``python -m skoots_tpu_torch.train`` on tif + YAML data on the CPU:
    the epoch loss falls (the random augmentations are off, so the epochs
    differ only in their crops), and the checkpoint loads in both packages
    with equal forwards at f32 (2e-5, as tests/test_torch_model.py)."""
    from skoots_tpu_torch.train.cli import main

    monkeypatch.chdir(tmp_path)  # tensorboard's ./runs, if installed
    save_dir = str(tmp_path / "models")
    cfg = {
        "MODEL": TINY_MODEL,
        "TRAIN": {"TRAIN_DATA_DIR": [tif_dir], "TRAIN_SAMPLE_PER_IMAGE": [2],
                  "NUM_EPOCHS": 3, "SAVE_INTERVAL": 3, "SAVE_PATH": save_dir,
                  "MAX_SKELETON_POINTS": 128, "LEARNING_RATE": 1e-2,
                  "LOSS_SKELETON_START_EPOCH": -1, "INITIAL_SIGMA": [8.0, 8.0, 4.0]},
        "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8,
                         **{k: 0.0 for k in ("ELASTIC_RATE", "AFFINE_RATE", "FLIP_RATE",
                                             "NOISE_RATE", "BRIGHTNESS_RATE",
                                             "CONTRAST_RATE", "INVERT_RATE")}},
        "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
    }
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    with caplog.at_level(logging.INFO, logger="skoots_tpu_torch.train.engine"):
        assert main(["--config-file", str(p), "--steps-per-epoch", "4", "--log", "2",
                     "--device", "cpu"]) == 0
    losses = [r.args[1]["loss"] for r in caplog.records
              if r.msg.startswith("epoch %d: ")]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    ckpts = [f for f in os.listdir(save_dir) if f.endswith(".skoots")]
    assert len(ckpts) == 1
    path = os.path.join(save_dir, ckpts[0])

    tm = model_from_checkpoint(load_checkpoint(path))
    ck = jax_load_checkpoint(path)
    assert ck["extra"]["epoch"] == 2 and ck["dataset_std"] > 0
    jmodel, tmpl = jax_init_model(ck["cfg"], jax.random.PRNGKey(0), spatial=(16, 16, 8))
    jparams = restore_params(tmpl, ck["params"])
    x = np.random.default_rng(0).standard_normal((1, 32, 32, 8, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x), deterministic=True))
    got = tm(T(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_train_cli_refuses_a_mesh_and_needs_a_config(tmp_path):
    from skoots_tpu_torch.train.cli import main

    assert main([]) == 2
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump({"SYSTEM": {"MESH_SPACE": 2}}))
    # a 1 x 2 mesh over the one device the call names: JAX's assertion
    with pytest.raises(AssertionError, match="mesh 1x2 != 1 devices"):
        main(["--config-file", str(p), "--device", "cpu"])
