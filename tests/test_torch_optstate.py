"""The optimizer state's round trip between the port and the JAX package,
for AdamW, Adam, Adamax and SGD with and without momentum: the port's
updates against optax's, the state's layout against
``flax.serialization.to_state_dict`` of JAX's optimizer state, a JAX
checkpoint resumed by the port's ``train`` with
``LOAD_PRETRAINED_OPTIMIZER``, and the port's checkpoint read back by JAX's
``restore_params``. Tolerances are stated at each comparison."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from skoots_tpu.train.checkpoint import restore_params
from skoots_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from skoots_tpu.train.engine import cfg_optimizer as jax_cfg_optimizer
from skoots_tpu.train.engine import make_train_step as jax_make_train_step
from skoots_tpu.train.sigma import init_sigma as jax_init_sigma
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch import config as C
from skoots_tpu_torch.checkpoint import flax_params_from_torch, load_checkpoint
from skoots_tpu_torch.models import init_model
from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask
from skoots_tpu_torch.train.engine import cfg_optimizer, flax_opt_state, train

T = torch.from_numpy

OPTIMIZERS = {
    "adamw": {"OPTIMIZER": "adamw", "WEIGHT_DECAY": 1e-2},
    "adam": {"OPTIMIZER": "adam"},
    "adamax": {"OPTIMIZER": "adamax"},
    "sgd": {"OPTIMIZER": "sgd"},
    "sgd_momentum": {"OPTIMIZER": "sgd", "OPTIMIZER_KEYWORD_ARGUMENTS": ["momentum"],
                     "OPTIMIZER_KEYWORD_VALUES": [0.9]},
}
TINY_MODEL = {"DIMS": [4, 8, 4], "DEPTHS": [1, 1, 1], "OUT_CHANNELS": 4, "KERNEL_SIZE": 3,
              "DTYPE": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(name, **train):
    update = {"MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
              "TRAIN": {"LEARNING_RATE": 1e-2, "LOSS_SKELETON_START_EPOCH": -1,
                        **OPTIMIZERS[name], **train}}
    jc = jax_defaults()
    jc.merge_from_dict(update)
    return jc, C.merge_from_dict(C.get_cfg_defaults(), update)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_five_steps_match_optax(name, rng):
    """Five updates on the same gradients, the lr injected per step as the
    JAX loop does: the port's parameters within 1e-6 * max|p| of optax's
    after every step."""
    jc, tc = _cfgs(name)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    opt, _ = jax_cfg_optimizer(jc)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(T(v.copy())) for k, v in p0.items()}
    topt, _ = cfg_optimizer(tc, list(tp.values()))
    for i, g in enumerate(grads):
        lr = np.float32(1e-2 * (1 + i) / 5)
        state.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = T(g[k])
        topt.param_groups[0]["lr"] = float(lr)
        topt.step()
        for k in p0:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].detach().numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{k} {i}")


def _batch(shape=(16, 16, 8)):
    img, lab, sk = make_tubes(shape, 2, radius=3, seed=9)
    packed = pack_skeletons(sk)
    return {"image": ((img.astype(np.float32) - 60) / 30)[None, ..., None],
            "masks": (lab > 0).astype(np.float32)[None, ..., None],
            "baked": bake_skeleton(T(lab), packed, (1.0, 1.0, 3.0)).numpy()[None],
            "skele_masks": skeleton_to_mask(packed, shape, 3, 3).numpy()[None, ..., None]}


def _jax_steps(jc, params, opt_state, batch, n):
    """``n`` JAX train steps, op by op: the loss's gradient, the epoch-0 lr
    injected, ``optimizer.update``."""
    opt, sched = jax_cfg_optimizer(jc)
    model, _ = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    step = jax_make_train_step(model, opt, sched, jax_init_sigma(jc), jc)
    sig = jnp.asarray(jax_init_sigma(jc).host(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(n):
        (_, _), grads = jax.value_and_grad(step.loss_fn, has_aux=True)(
            params, jb, jnp.asarray(0), sig, {"droppath": jax.random.PRNGKey(1)})
        opt_state.hyperparams["learning_rate"] = jnp.asarray(np.float32(sched(0)))
        upd, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
    return params, opt_state


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_from_jax_and_back(name, tmp_path):
    """JAX takes 2 steps and saves params and optimizer state; the port's
    ``train`` resumes from that file with ``LOAD_PRETRAINED_OPTIMIZER`` and
    takes one f32 step, JAX the same step from the same file: parameters
    within 1e-5 * max|p|. The port's layout equals ``to_state_dict`` of
    JAX's state leaf for leaf (names, shapes, dtypes), and JAX's
    ``restore_params`` reads the port's checkpoint back with mu, nu (or
    the momentum trace) and count equal to the port's."""
    batch = _batch()
    jc, _ = _cfgs(name)
    opt, _ = jax_cfg_optimizer(jc)
    _, params = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    params, state = _jax_steps(jc, params, opt.init(params), batch, 2)
    first = str(tmp_path / "jax2.skoots")
    jax_save_checkpoint(first, jc, params, state, dataset_mean=60.0, dataset_std=30.0)

    want_params, want_state = _jax_steps(jc, params, state, batch, 1)
    jc2, tc = _cfgs(name, PRETRAINED_MODEL_PATH=[first], LOAD_PRETRAINED_OPTIMIZER=True,
                    NUM_EPOCHS=1, SAVE_PATH=str(tmp_path / "port"))
    tb = {k: T(v) for k, v in batch.items()}
    result = train(tc, lambda e: iter([tb]), "cpu", dataset_mean=60.0, dataset_std=30.0)
    got = _flat(flax_params_from_torch(result.model.state_dict()))
    for k, v in _flat(want_params).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5 * np.abs(v).max(), err_msg=k)

    port = flax_opt_state(result.optimizer, result.model, tc, 3)
    layout = serialization.to_state_dict(jax.device_get(want_state))
    want_flat, port_flat = _flat(layout), _flat(port)
    assert want_flat.keys() == port_flat.keys()
    for k, v in want_flat.items():
        assert port_flat[k].shape == v.shape and port_flat[k].dtype == v.dtype, k

    ckpts = [f for f in os.listdir(tmp_path / "port") if f.endswith(".skoots")]
    ck = jax_load_checkpoint(str(tmp_path / "port" / ckpts[0]))
    restored = _flat(serialization.to_state_dict(
        restore_params(opt.init(params), ck["opt_state"])))
    for k, v in port_flat.items():
        if "hyperparams" not in k:
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
    assert int(restored["count"]) == 3
    assert load_checkpoint(str(tmp_path / "port" / ckpts[0]))["opt_state"]["count"] == 3


def test_fresh_state_writes_zero_moments():
    """Before any update the port writes zero moments and count 0, as
    ``optimizer.init`` gives them."""
    jc, tc = _cfgs("adamw")
    model = init_model(tc, 0)
    topt, _ = cfg_optimizer(tc, model.parameters())
    st = flax_opt_state(topt, model, tc, 0)
    assert int(st["count"]) == 0
    for k, v in _flat(st["inner_state"]).items():
        assert not v.any(), k
