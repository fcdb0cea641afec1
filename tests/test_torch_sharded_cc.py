"""The sharded pipeline's CC and assignment (``run.cc``, ``run.assign`` of
``skoots_tpu_torch/infer/sharded.py``) against JAX's on its 8 virtual CPU
devices, given the same inputs: JAX's own ``run.fwd`` outputs at JAX's
test cfg, and a skeleton of tubes across every slab seam. Labels and
instances must be equal exactly, for every ``label_gather`` /
``walk_gather`` combination, with and without axis sweeps, and when the
round cap cuts the CC short (with JAX's warning)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.infer import sharded as J
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.parallel import make_mesh as jax_make_mesh
from skoots_tpu_torch import config as C
from skoots_tpu_torch.infer import sharded as T
from skoots_tpu_torch.models import cfg_to_model, load_flax_params
from skoots_tpu_torch.parallel import make_mesh

TINY = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
        "KERNEL_SIZE": 3, "DTYPE": "float32"}
SHAPE = (62, 30, 8)  # padded to 64 x 32 x 8 on 8 slabs of 8 planes
KW = dict(vector_scale=(8.0, 8.0, 4.0), prob_threshold=0.5, embed_iterations=3,
          cc_rounds=2, cc_propagates_per_round=4)
MODES = [("ring", "ring"), ("ring", "replicated"), ("replicated", "replicated")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    jc = get_cfg_defaults()
    jc.merge_from_dict({"MODEL": TINY})
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    tc = C.merge_from_dict(C.get_cfg_defaults(), {"MODEL": TINY})
    tmodel = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, jparams))
    jmesh = jax_make_mesh(data=1, space=8, devices=jax.devices()[:8])
    tmesh = make_mesh(1, 8, ["cpu"] * 8)
    # JAX's phase 1 on a reflect-padded random volume
    vol = np.random.default_rng(4).random(SHAPE, np.float32) * 255
    vol = np.pad(vol, ((0, 2), (0, 2), (0, 0)), mode="reflect")
    jrun = J.make_sharded_pipeline(jmodel, jmesh, SHAPE, **KW)
    jvec, jskel = jrun.fwd(jparams, J.shard_volume(jnp.asarray(vol)[None, ..., None], jmesh),
                           jnp.float32(128.0), jnp.float32(64.0))
    vec = np.asarray(jvec.astype(jnp.float32))[0]
    skel = np.asarray(jskel)[0, ..., 0]
    # tubes crossing every seam (bit 0; bit 1 keeps JAX's semantic decision)
    tubes = np.zeros((64, 32, 8), np.uint8)
    tubes[2:60, 4:6, 2:4] = 1
    tubes[:, 10:12, 5:7] = 1
    tubes[5:30, 20, 1] = 1
    tubes[33:64, 20, 1] = 1
    tubes[40:50, 25:28, 3:6] = 1
    tubes[61:64, 0:3, 0:2] = 1  # in the reflect pad: masked out of the CC
    tubes = tubes | (skel & 2)
    return jmodel, tmodel, jmesh, tmesh, vec, {"fwd": skel, "tubes": tubes}


def _jax(jmodel, jmesh, lg, wg, scans, vec, skel, **kw):
    jrun = J.make_sharded_pipeline(jmodel, jmesh, SHAPE, label_gather=lg, walk_gather=wg,
                                   cc_scans_per_round=scans, **{**KW, **kw})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        labels = jrun.cc(jnp.asarray(skel))
    inst = jrun.assign(labels, jnp.asarray(vec, jnp.bfloat16)[None], jnp.asarray(skel))
    capped = any("before convergence" in str(w.message) for w in rec)
    return np.asarray(labels), np.asarray(inst)[0], capped


def _port(tmodel, tmesh, lg, wg, scans, vec, skel, **kw):
    trun = T.make_sharded_pipeline(tmodel, tmesh, SHAPE, label_gather=lg, walk_gather=wg,
                                   cc_scans_per_round=scans, **{**KW, **kw})
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        labels = trun.cc(torch.from_numpy(skel))
    inst = trun.assign(labels, torch.from_numpy(vec).to(torch.bfloat16), torch.from_numpy(skel))
    capped = any("before convergence" in str(w.message) for w in rec)
    return labels.whole().numpy(), inst.whole().numpy(), capped, trun


@pytest.mark.parametrize("scans", [0, 1])
@pytest.mark.parametrize("source", ["fwd", "tubes"])
def test_cc_and_assign_equal_jax(setup, source, scans):
    jmodel, tmodel, jmesh, tmesh, vec, skels = setup
    skel = skels[source]
    for lg, wg in MODES:
        jl, ji, jcap = _jax(jmodel, jmesh, lg, wg, scans, vec, skel)
        tl, ti, tcap, trun = _port(tmodel, tmesh, lg, wg, scans, vec, skel)
        np.testing.assert_array_equal(tl, jl, err_msg=f"labels {lg}/{wg}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"instances {lg}/{wg}")
        assert tcap == jcap
    n_labels = len(np.unique(jl[jl > 0]))
    assert n_labels >= (1 if source == "fwd" else 4) and (ji > 0).sum() > 100
    assert trun.cc.hop_chunks == [4] and len(trun.bounds) == 8
    assert trun.cc.last_converged


def test_round_cap_warns_and_labels_equal_jax(setup):
    """A serpentine path of ~1000 hops against a cap of
    ``max(2 * 4, 4 * (64 + 32 + 8))`` = 416 hops: both warn, and the
    labels the cap leaves are equal; a ~190-hop path converges past the
    caller's 8-hop budget with no warning."""
    jmodel, tmodel, jmesh, tmesh, vec, _ = setup
    snake = np.zeros((64, 32, 8), np.uint8)
    for j in range(0, 30, 2):
        snake[:62, j, 0] = 1
        snake[61 if (j // 2) % 2 == 0 else 0, j + 1, 0] = 1
    short = np.zeros((64, 32, 8), np.uint8)
    short[:62, 0, 0] = 1
    short[61, 1, 0] = 1
    short[:62, 2, 0] = 1
    for skel, want_cap in ((snake | 2, True), (short | 2, False)):
        jl, ji, jcap = _jax(jmodel, jmesh, "ring", "ring", 0, vec, skel)
        tl, ti, tcap, trun = _port(tmodel, tmesh, "ring", "ring", 0, vec, skel)
        assert jcap == tcap == want_cap
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti, ji)
        assert trun.cc.last_converged == (not want_cap)
    assert len(np.unique(tl[tl > 0])) == 1
