"""Data-parallel training of the port (``train/engine.py``'s ``mesh=``,
``train/cli.py::train_mesh``) against its own one-device step and JAX's
mesh step (``skoots_tpu/train/engine.py`` on ``make_mesh(data=2)`` of its
8 virtual CPU devices), with a whole-batch loss (``dice``), at the tiny
f32 cfg of ``tests/test_torch_train.py``."""

import numpy as np
import pytest
import torch
import yaml

from skoots_tpu_torch import config as C
from skoots_tpu_torch.models import cfg_to_model, init_model, load_flax_params
from skoots_tpu_torch.parallel import make_mesh
from skoots_tpu_torch.train.cli import train_mesh
from skoots_tpu_torch.train.engine import (
    cfg_optimizer,
    drop_path_generator,
    make_train_step,
)
from skoots_tpu_torch.train.sigma import init_sigma

TINY = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
        "KERNEL_SIZE": 3, "DTYPE": "float32"}
UPDATE = {"MODEL": TINY, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
          "TRAIN": {"LOSS_SKELETON_START_EPOCH": -1, "LOSS_EMBED": "dice",
                    "TRAIN_BATCH_SIZE": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(b=2, shape=(16, 16, 8), seed=0):
    """Two different samples: tubes from JAX's phantom helper, baked."""
    from skoots_tpu.utils.synthetic import make_tubes as jax_make_tubes
    from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask

    items = []
    for i in range(b):
        img, lab, sk = jax_make_tubes(shape, 2, radius=3, seed=9 + i + seed)
        packed = pack_skeletons(sk)
        baked = bake_skeleton(torch.from_numpy(lab), packed, (1.0, 1.0, 3.0)).numpy()
        skel = skeleton_to_mask(packed, shape, 3, 3).numpy()
        items.append({"image": ((img.astype(np.float32) - 60) / 30)[..., None],
                      "masks": (lab > 0).astype(np.float32)[..., None], "baked": baked,
                      "skele_masks": skel[..., None]})
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _port_grads(cfg, batch, mesh, drop_gen, params=None):
    model = cfg_to_model(cfg) if params is not None else init_model(cfg, 0, device="cpu")
    if params is not None:
        load_flax_params(model, params)
    model.train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg, mesh)
    total, _ = step.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}, 0, drop_gen)
    total.backward()
    return float(total.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_data_parallel_step_equals_one_device_step():
    """Data 2 on ``["cpu", "cpu"]`` against one device at batch 2, dice as
    the embedding loss (a sum over the whole batch) and DropPath 0.1 (the
    masks drawn for the whole batch, then split): the loss within 1e-6
    relative, every gradient within 1e-6 of the step's largest gradient
    (the batch's sums split in two)."""
    cfg = C.merge_from_dict(C.get_cfg_defaults(),
                            {**UPDATE, "MODEL": {**TINY, "DROP_PATH_RATE": 0.1}})
    batch = _batch()
    one, g1 = _port_grads(cfg, batch, None, drop_path_generator(0, 3))
    two, g2 = _port_grads(cfg, batch, make_mesh(2, 1, ["cpu", "cpu"]),
                          drop_path_generator(0, 3))
    np.testing.assert_allclose(two, one, rtol=1e-6)
    top = max(float(g.abs().max()) for g in g1.values())
    for n in g1:
        np.testing.assert_allclose(g2[n].numpy(), g1[n].numpy(), rtol=0, atol=1e-6 * top,
                                   err_msg=n)
    # the masks dropped something: without DropPath the loss differs
    plain, _ = _port_grads(cfg, batch, None, None)
    assert abs(plain - one) > 1e-4


def test_data_parallel_step_matches_jax_mesh_step():
    """JAX's jitted step over ``make_mesh(data=2)`` (GSPMD) against the
    port's data-2 step from JAX's weights, SGD at lr 1 (so the update is
    the gradient), no DropPath (JAX's PRNG masks cannot be matched): the
    loss within 1e-5 relative, each gradient leaf within 1e-3 x its max
    (as tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp

    from skoots_tpu.config import get_cfg_defaults
    from skoots_tpu.models import init_model as jax_init_model
    from skoots_tpu.parallel import make_mesh as jax_make_mesh
    from skoots_tpu.train.engine import TrainState
    from skoots_tpu.train.engine import cfg_optimizer as jax_cfg_optimizer
    from skoots_tpu.train.engine import make_train_step as jax_make_train_step
    from skoots_tpu.train.sigma import init_sigma as jax_init_sigma
    from skoots_tpu_torch.checkpoint import flax_params_from_torch

    upd = {**UPDATE, "TRAIN": {**UPDATE["TRAIN"], "OPTIMIZER": "sgd", "LEARNING_RATE": 1.0,
                               "WEIGHT_DECAY": 0.0}}
    jc = get_cfg_defaults()
    jc.merge_from_dict(upd)
    cfg = C.merge_from_dict(C.get_cfg_defaults(), upd)
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    jmesh = jax_make_mesh(data=2, space=1, devices=jax.devices()[:2])
    opt, sched = jax_cfg_optimizer(jc)
    jstep = jax_make_train_step(jmodel, opt, sched, jax_init_sigma(jc), jc, jmesh)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                       opt_state=opt.init(jparams))
    batch = _batch(seed=5)
    p0 = jax.tree_util.tree_map(np.asarray, jparams)
    new, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jnp.asarray(0), jax.random.PRNGKey(1))
    jgrads = jax.tree_util.tree_map(lambda a, b: a - np.asarray(b), p0, new.params)

    loss, grads = _port_grads(cfg, batch, make_mesh(2, 1, ["cpu", "cpu"]), None, params=p0)
    np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
    tflat = dict(jax.tree_util.tree_flatten_with_path(flax_params_from_torch(grads))[0])
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tflat)
    for path, jg in jflat:
        np.testing.assert_allclose(tflat[path], jg, rtol=0, atol=1e-3 * np.abs(jg).max(),
                                   err_msg=str(path))


def test_train_mesh_follows_jax_rule():
    cfg = C.merge_from_dict(C.get_cfg_defaults(), UPDATE)
    assert train_mesh(cfg, ["cpu"]) is None
    mesh = train_mesh(cfg, [torch.device("cpu")] * 4)  # -1: gcd(batch 2, 4) = 2
    assert mesh.shape == {"data": 2, "space": 1}
    bad = C.merge_from_dict(cfg, {"SYSTEM": {"MESH_DATA": 3}, "TRAIN": {"TRAIN_BATCH_SIZE": 4}})
    with pytest.raises(ValueError, match="does not divide"):
        train_mesh(bad, [torch.device("cpu")] * 4)
    space = C.merge_from_dict(cfg, {"SYSTEM": {"MESH_DATA": 2, "MESH_SPACE": 2}})
    with pytest.raises(AssertionError, match="mesh 2x2 != 2 devices"):
        train_mesh(space, [torch.device("cpu")] * 2)


def test_run_config_trains_on_a_data_2_mesh(tmp_path, monkeypatch):
    """``skoots-train-torch --device cpu,cpu`` with ``MESH_DATA 2`` trains
    2 steps over the mesh and saves a checkpoint; a non-dividing
    ``MESH_DATA`` raises."""
    from skoots_tpu.utils.io import imsave
    from skoots_tpu.utils.synthetic import make_tubes as jax_make_tubes
    from skoots_tpu_torch.train import engine
    from skoots_tpu_torch.train.cli import main
    from skoots_tpu_torch.train.generate_skeletons import save_skeletons

    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    data.mkdir()
    for i in range(2):
        img, lab, sk = jax_make_tubes(shape=(64, 64, 8), n_tubes=2, seed=i)
        imsave(str(data / f"v{i}.tif"), img)
        imsave(str(data / f"v{i}.labels.tif"), lab)
        save_skeletons(str(data / f"v{i}.skeletons.npz"), sk)
    cfg = {"MODEL": TINY, "SYSTEM": {"MESH_DATA": 2},
           "TRAIN": {"TRAIN_DATA_DIR": [str(data)], "TRAIN_SAMPLE_PER_IMAGE": [2],
                     "TRAIN_BATCH_SIZE": 2, "NUM_EPOCHS": 1, "SAVE_INTERVAL": 1,
                     "SAVE_PATH": str(tmp_path / "models"), "MAX_SKELETON_POINTS": 64,
                     "LOSS_SKELETON_START_EPOCH": -1, "LOSS_EMBED": "dice"},
           "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8,
                            **{k: 0.0 for k in ("ELASTIC_RATE", "AFFINE_RATE")}},
           "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}}
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(cfg))
    seen = []
    real = engine.make_train_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)
        seen.append(args[5] if len(args) > 5 else kwargs.get("mesh"))

        def counted(batch, epoch):
            seen.append(batch["image"].shape[0])
            return step(batch, epoch)
        return counted

    monkeypatch.setattr(engine, "make_train_step", spy)
    assert main(["--config-file", str(p), "--steps-per-epoch", "2", "--device", "cpu,cpu",
                 "--log", "0"]) == 0
    assert seen[0].shape == {"data": 2, "space": 1} and seen[1:] == [2, 2]
    assert len(list((tmp_path / "models").glob("*.skoots"))) == 1
    cfg["SYSTEM"]["MESH_DATA"] = 3
    p.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="does not divide"):
        main(["--config-file", str(p), "--device", "cpu,cpu,cpu", "--log", "0"])
