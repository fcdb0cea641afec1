"""The port's sharded inference (``skoots_tpu_torch/infer/sharded.py``)
against the JAX package's on its 8 virtual CPU devices, at JAX's test cfg
(dims 4-8-16-8-4, depth 1, k 3; ``tests/test_sharded_inference.py``) in
f32, the weights carried across by the port's checkpoint converter: the
sizing helpers, the sharded forward, ``make_sharded_assign``, UNet3D's
sharded forward against its unsharded one, and ``run_inference``'s sharded
branch. ``tests/test_torch_sharded_cc.py`` holds the CC and the walk."""

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
from skoots_tpu_torch.models import cfg_to_model, init_model, load_flax_params
from skoots_tpu_torch.parallel import make_mesh

TINY = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
        "KERNEL_SIZE": 3, "DTYPE": "float32"}
# the random-weight model's probabilities lie in ~0.24-0.76: a gate at 0.5
# keeps about a third of the voxels (its skeleton channel, near-constant,
# dilates to nearly everything)
PROB = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jc = get_cfg_defaults()
    jc.merge_from_dict({"MODEL": TINY})
    jmodel, jparams = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    tc = C.merge_from_dict(C.get_cfg_defaults(), {"MODEL": TINY})
    tmodel = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel.eval()


def test_sizing_helpers_match_jax():
    """``estimated_bytes_per_device`` and ``resolve_spatial_shards`` equal
    JAX's over shapes, device counts and limits (the port's forward term
    left at its default 0)."""
    shapes = [(16, 512, 512), (60, 30, 7), (256, 256, 256), (512, 512, 512),
              (1024, 1024, 1024), (8, 8, 8)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            for mode in ("replicated", "ring"):
                assert T.estimated_bytes_per_device(shape, n, mode) == \
                    J.estimated_bytes_per_device(shape, n, mode)
            ring, rep = (J.estimated_bytes_per_device(shape, n, m)
                         for m in ("ring", "replicated"))
            for limit in (None, 1024, ring // 2, ring, (ring + rep) // 2, rep * 2):
                for req in (None, 0, 1, 4):
                    assert T.resolve_spatial_shards(req, n, shape, limit) == \
                        J.resolve_spatial_shards(req, n, shape, limit), (shape, n, limit, req)
    # the forward's own bytes a voxel of a slab add to either mode
    assert T.estimated_bytes_per_device((64, 64, 64), 4, "ring", 100) == \
        J.estimated_bytes_per_device((64, 64, 64), 4, "ring") + 100 * 64**3 // 4
    assert T.device_bytes_limit("cpu") is None


def test_slab_layout():
    assert T.slab_bounds(64, 4, 4) == [(0, 16), (16, 32), (32, 48), (48, 64)]
    # boundaries on multiples of the quantum, the first slabs one larger
    assert T.slab_bounds(60, 4, 4) == [(0, 16), (16, 32), (32, 48), (48, 60)]
    assert T.slab_bounds(62, 3, 4) == [(0, 24), (24, 44), (44, 62)]
    with pytest.raises(ValueError, match="at most 2"):
        T.slab_bounds(8, 4, 4)
    mesh = make_mesh(1, 3, ["cpu"] * 3)
    t = torch.arange(62 * 2).view(62, 2)
    s = T.shard_volume(t, mesh, 0, T.slab_bounds(62, 3, 4))
    assert [tuple(p.shape) for p in s.parts] == [(24, 2), (20, 2), (18, 2)]
    assert torch.equal(s.whole(), t) and torch.equal(s.gather(20, 30, "cpu"), t[20:30])


def _jax_padded(vol, n):
    mx = np.lcm(4, n)
    x, y, z = vol.shape
    pads = ((0, -(-x // mx) * mx - x), (0, -(-y // 4) * 4 - y), (0, -(-z // 4) * 4 - z))
    return np.pad(vol, pads, mode="reflect")


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("shape", [(64, 32, 8), (62, 30, 8)])
def test_sharded_forward_matches_jax(models, n, shape):
    """The port's halo-exchanged forward against JAX's GSPMD forward on the
    same reflect-padded volume: the gated bf16 vectors within 1 bf16 ulp
    of 1 (|v| < 1) where both keep the voxel, and each decision bit on at
    least 99.9% of the voxels (f32 sums in another order can flip a voxel
    that sits on a threshold)."""
    jmodel, jparams, tmodel = models
    rng = np.random.default_rng(0)
    vol = _jax_padded(rng.random(shape, np.float32) * 255, n)
    jmesh = jax_make_mesh(data=1, space=n, devices=jax.devices()[:n])
    jfwd = J.make_sharded_forward(jmodel, jmesh, prob_threshold=PROB)
    jvec, jpacked = jfwd(jparams, J.shard_volume(jnp.asarray(vol)[None, ..., None], jmesh),
                         jnp.float32(128.0), jnp.float32(64.0))
    jvec = np.asarray(jvec.astype(jnp.float32))[0]
    jpacked = np.asarray(jpacked)[0, ..., 0]

    fwd = T.make_sharded_forward(tmodel, make_mesh(1, n, ["cpu"] * n), prob_threshold=PROB)
    vec, packed = fwd(torch.from_numpy(vol), 128.0, 64.0)
    assert len(vec.parts) == n and all(p.shape[0] % 4 == 0 for p in vec.parts[:-1])
    tvec = vec.whole().float().numpy()
    tpacked = packed.whole().numpy()
    for bit in (0, 1):
        agree = (((tpacked >> bit) & 1) == ((jpacked >> bit) & 1)).mean()
        assert agree >= 0.999, (bit, agree)
    assert 0.05 < (tpacked >> 1).mean() < 0.95
    both = np.any(tvec != 0, -1) & np.any(jvec != 0, -1)
    assert both.mean() > 0.1
    np.testing.assert_allclose(tvec[both], jvec[both], atol=2.0**-8, rtol=0)


def test_sharded_assign_matches_jax(models):
    """``make_sharded_assign`` (both label gathers) on JAX's test inputs:
    the instances equal JAX's exactly."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 9, (64, 32, 8)).astype(np.int32)
    vec = rng.random((1, 64, 32, 8, 3), np.float32) * 2 - 1
    vec[0, :5] = 0  # all-zero vectors take no label
    jmesh = jax_make_mesh(data=1, space=8, devices=jax.devices()[:8])
    tmesh = make_mesh(1, 8, ["cpu"] * 8)
    for gather in ("ring", "replicated"):
        ja = J.make_sharded_assign(jmesh, (8.0, 8.0, 4.0), embed_iterations=3,
                                   label_gather=gather)
        want = np.asarray(ja(jnp.asarray(labels), J.shard_volume(jnp.asarray(vec), jmesh)))[0]
        ta = T.make_sharded_assign(tmesh, (8.0, 8.0, 4.0), embed_iterations=3,
                                   label_gather=gather)
        got = ta(torch.from_numpy(labels), T.shard_volume(torch.from_numpy(vec[0]), tmesh, 0))
        np.testing.assert_array_equal(got.whole().numpy(), want)
    assert (want[:5] == 0).all() and (want != 0).mean() > 0.5


def test_unet3d_sharded_forward_matches_unsharded():
    """UNet3D (GroupNorm statistics reduced over the slabs) at 2, 3 and 4
    slabs of a 62x30x8 volume against the port's unsharded forward: f32
    outputs within 1e-5."""
    tc = C.merge_from_dict(C.get_cfg_defaults(), {"MODEL": {**TINY, "ARCHITECTURE": "bism_unet"}})
    model = init_model(tc, 0, device="cpu").eval()
    vol = _jax_padded(np.random.default_rng(3).random((62, 30, 8), np.float32) * 255, 4)
    x = torch.from_numpy((vol - 128.0) / 64.0)[None, ..., None]
    with torch.no_grad():
        want = model(x)
    for n in (2, 3, 4):
        fwd = T.make_sharded_forward(model, make_mesh(1, n, ["cpu"] * n))
        xs = T.shard_volume(x, make_mesh(1, n, ["cpu"] * n), 1,
                            T.slab_bounds(x.shape[1], n, fwd.quantum))
        got = fwd.outputs(xs).whole()
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_run_inference_sharded_matches_jax(tmp_path, monkeypatch):
    """``run_inference`` on a tiny f32 checkpoint and a tube volume: the
    port on ``["cpu"] * 4`` with ``spatial_shards=4`` and ``None`` (auto:
    4 here) and on ``["cpu"] * 8`` with ``None`` (7, as JAX's auto picks on
    its 8 devices) writes JAX's mask exactly; an explicit request past the
    devices' memory raises JAX's message."""
    from skoots_tpu.infer.engine import run_inference as jax_run
    from skoots_tpu.train.checkpoint import save_checkpoint
    from skoots_tpu.utils.io import imread, imsave
    from skoots_tpu.utils.synthetic import make_tubes
    from skoots_tpu_torch.infer import engine

    jc = get_cfg_defaults()
    jc.merge_from_dict({"MODEL": TINY, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]}})
    _, params = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    ckpt = str(tmp_path / "m.skoots")
    save_checkpoint(ckpt, jc, params, dataset_mean=128.0, dataset_std=64.0)
    img, _, _ = make_tubes(shape=(62, 32, 8), n_tubes=3)
    path = str(tmp_path / "v.tif")
    imsave(path, img)
    for shards, devices in ((4, ["cpu"] * 4), (None, ["cpu"] * 8), (None, ["cpu"] * 4)):
        want = jax_run(path, ckpt, spatial_shards=4 if shards == 4 or len(devices) == 4
                       else None, prob_threshold=PROB, output_path=str(tmp_path / "j.tif"))
        got = engine.run_inference(path, ckpt, spatial_shards=shards, prob_threshold=PROB,
                                   device=devices, output_path=str(tmp_path / "t.tif"))
        assert engine.last_stats["engine"] == "sharded"
        assert engine.last_stats["spatial_shards"] == (4 if len(devices) == 4 else 7)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(imread(str(tmp_path / "t.tif")), want)
        assert len(np.unique(want)) > 2
    assert (tmp_path / "v_skoots_benchmark.txt").exists()
    monkeypatch.setattr("skoots_tpu_torch.infer.sharded.device_bytes_limit", lambda d=None: 1024)
    with pytest.raises(ValueError, match="host-streaming"):
        engine.run_inference(path, ckpt, spatial_shards=4, device=["cpu"] * 4)
    with pytest.raises(ValueError, match="needs that many devices, have 4"):
        engine.run_inference(path, ckpt, spatial_shards=8, device=["cpu"] * 4)
