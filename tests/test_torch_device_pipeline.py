"""The port's single-program pipeline (``skoots_tpu_torch/infer/
device_pipeline.py::make_device_pipeline``) against the JAX package's, on
the CPU, and ``segment_volume_chunked`` against the chunked pipeline it
wraps.

Given the same forward output (a model that returns it, or a pointwise
model computed with exact f32 products) the instance volumes are EQUAL:
the tiling, reflect pads, overlap writes, bf16 vector buffer, CC and
assignment all follow JAX's. With a tiny f32 UNeXT in the loop the two
forwards differ by float rounding, so the bar there is the same instance
count and every instance matched at IoU >= 0.95.

JAX is imported inside the tests (``jax_pipeline``), so the ``cuda`` case
runs on a card's machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_pipeline.py -m cuda
"""

import numpy as np
import pytest
import torch

from skoots_tpu_torch.infer import device_pipeline as tdp
from skoots_tpu_torch.utils.synthetic import make_tubes

SHAPE = (48, 48, 24)
SCALE = (12.0, 12.0, 6.0)  # the bench checkpoint's VECTOR_SCALING
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite's parallel workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_pipeline():
    """JAX's ``infer.device_pipeline`` module (the reference)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from skoots_tpu.infer import device_pipeline

    return device_pipeline


@pytest.fixture(scope="module")
def phantom():
    """(image u8, ideal 5-channel forward output with noisy probability
    channels) of a four-tube volume."""
    from skoots_tpu.utils.synthetic import perfect_prediction

    img, lab, sk = make_tubes(shape=SHAPE, n_tubes=4, min_separation=14.0, seed=3)
    out = perfect_prediction(lab, sk, vector_scale=SCALE)
    noise = np.random.default_rng(0).uniform(0.0, 0.3, SHAPE + (2,))
    out[..., 3:5] = np.clip(out[..., 3:5] * 0.85 + noise, 0.0, 1.0)
    return img, out.astype(np.float32)


class _JaxOut:
    """A flax-like model whose 'params' are the whole forward output."""

    def apply(self, params, x, deterministic=True):
        return params[None]


class _TorchOut(torch.nn.Module):
    def __init__(self, out):
        super().__init__()
        self.out = T(out)

    def forward(self, x):
        return self.out[None]


@pytest.mark.parametrize("dtype,knobs", [
    ("bfloat16", {}),
    ("float32", {"embed_compact_div": 16}),
    ("bfloat16", {"embed_exit_fraction": 1e-3, "embed_exit_cycle": True}),
    ("bfloat16", {"cc_rounds": 2, "cc_propagates_per_round": 3}),
])
def test_device_pipeline_matches_jax_given_forward(jax_pipeline, phantom, dtype, knobs):
    """One tile the size of the volume, the forward output injected into
    both: equal instance volumes (vectors rounded to ``dtype`` before the
    walk; an unconverged CC stops where JAX's does)."""
    import jax.numpy as jnp

    _, out = phantom
    kw = dict(crop=SHAPE, overlap=(0, 0, 0), vector_scale=SCALE, **knobs)
    vol = np.zeros(SHAPE, np.float32)
    want = np.asarray(jax_pipeline.make_device_pipeline(
        _JaxOut(), SHAPE, dtype=getattr(jnp, dtype), **kw)(
        jnp.asarray(out), jnp.asarray(vol), 0.0, 1.0))
    run = tdp.make_device_pipeline(_TorchOut(out), SHAPE, dtype=getattr(torch, dtype),
                                   device="cpu", **kw)
    got = run(vol, 0.0, 1.0)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) - 1 >= (1 if "cc_rounds" in knobs else 3)
    assert run.last_cc_converged == ("cc_rounds" not in knobs)
    assert run.tile_plan == {"forward": 1, "assign": 1}
    assert set(run.last_phase_s) == {"1-forward", "2-cc", "3-assign"}


def _pointwise_jax(x):
    """A stand-in forward computed voxel by voxel with exact f32 products
    only, so JAX and torch agree bit for bit on every tile."""
    import jax.numpy as jnp

    return jnp.concatenate([jnp.clip(x * 0.3, -1, 1), jnp.clip(x * -0.2, -1, 1),
                            jnp.clip(x * 0.1, -1, 1), jnp.clip(x * 0.25, 0, 1),
                            jnp.clip(x * 0.5, 0, 1)], -1)


def _pointwise_torch(x):
    return torch.cat([(x * 0.3).clamp(-1, 1), (x * -0.2).clamp(-1, 1),
                      (x * 0.1).clamp(-1, 1), (x * 0.25).clamp(0, 1),
                      (x * 0.5).clamp(0, 1)], -1)


class _JaxPointwise:
    def apply(self, params, x, deterministic=True):
        return _pointwise_jax(x)


class _TorchPointwise(torch.nn.Module):
    def forward(self, x):
        return _pointwise_torch(x)


# (volume shape, crop or None for JAX's default, forward tiles, assign tiles,
# the seed of a phantom whose tubes stay apart after the dilation stack)
TILINGS = [((48, 40, 12), None, 8, 1, 8),
           ((64, 64, 24), (32, 32, 16), 32, 8, 9),
           ((50, 45, 13), (24, 20, 8), 100, 18, 8)]


@pytest.mark.parametrize("shape,crop,n_fwd,n_assign,seed", TILINGS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else None)
def test_device_pipeline_tiling_matches_jax(jax_pipeline, shape, crop, n_fwd, n_assign, seed):
    """Several forward tiles with the default overlap (clamped to a quarter
    of the crop) and reflect pads, extents no tile divides, and assign
    tiles whose clamped last origins overlap: exact."""
    import jax.numpy as jnp

    img, _, _ = make_tubes(shape=shape, n_tubes=3, min_separation=16.0, seed=seed)
    # short walks, so each voxel lands on its own tube's skeleton
    kw = dict(vector_scale=(2.0, 2.0, 1.0), embed_iterations=3)
    if crop is not None:
        kw["crop"] = crop
    want = np.asarray(jax_pipeline.make_device_pipeline(_JaxPointwise(), shape, **kw)(
        None, jnp.asarray(img), 41.8, 20.4))
    run = tdp.make_device_pipeline(_TorchPointwise(), shape, device="cpu", **kw)
    got = run(img, 41.8, 20.4).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) - 1 >= 2
    assert run.tile_plan == {"forward": n_fwd, "assign": n_assign}


def _match_instances(a, b):
    """Instance count of each, and for every instance of ``a`` the IoU of
    its best-overlapping instance of ``b``."""
    ids_a = [i for i in np.unique(a) if i]
    ious = []
    for i in ids_a:
        m = a == i
        cand, cnt = np.unique(b[m], return_counts=True)
        j = cand[np.argmax(np.where(cand > 0, cnt, -1))]
        inter = int((m & (b == j)).sum()) if j else 0
        ious.append(inter / int((m | (b == j)).sum()))
    return len(ids_a), len([i for i in np.unique(b) if i]), ious


def test_tiny_model_device_pipeline_matches_jax(jax_pipeline):
    """A tiny f32 UNeXT with random weights through both pipelines (32
    forward tiles, overlap, reflect pads): same instances at IoU >= 0.95."""
    import jax
    import jax.numpy as jnp

    from skoots_tpu.config import get_cfg_defaults
    from skoots_tpu.models import init_model
    from skoots_tpu_torch.models import cfg_to_model, load_flax_params

    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 4], [1, 1, 1]
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 8, 3
    cfg.MODEL.DTYPE = "float32"
    cfg.freeze()
    model, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.5, jnp.float32), params)
    tm = load_flax_params(cfg_to_model(cfg.to_dict()),
                          jax.tree_util.tree_map(np.asarray, params))
    shape = (40, 40, 16)
    img, _, _ = make_tubes(shape=shape, n_tubes=3, min_separation=14.0, seed=2)
    vol = img.astype(np.float32)
    mean, std = float(vol.mean()), float(vol.std())
    kw = dict(crop=(24, 24, 16), vector_scale=(4.0, 4.0, 2.0), embed_iterations=4,
              prob_threshold=0.6)
    want = np.asarray(jax_pipeline.make_device_pipeline(model, shape, **kw)(
        params, jnp.asarray(vol), mean, std))
    got = tdp.make_device_pipeline(tm, shape, device="cpu", **kw)(vol, mean, std).numpy()
    n_want, n_got, ious = _match_instances(want, got)
    print(f"instances jax {n_want} torch {n_got}; min IoU {min(ious):.4f}; "
          f"{int((want != got).sum())} voxels differ")
    assert n_want >= 2 and n_got == n_want
    assert min(ious) >= 0.95


@pytest.mark.parametrize("knobs", [{}, {"assign_crop": (24, 24, 8), "embed_compact_div": 16}])
def test_segment_volume_chunked_is_the_chunked_pipeline(knobs):
    """``segment_volume_chunked`` returns what the chunked pipeline it
    builds returns, exactly."""
    img, _, _ = make_tubes(shape=(48, 40, 12), n_tubes=3, min_separation=16.0, seed=8)
    kw = dict(crop=(24, 24, 12), overlap=(4, 4, 2), vector_scale=(2.0, 2.0, 1.0),
              embed_iterations=3, device="cpu", **knobs)
    want = tdp.make_chunked_pipeline(_TorchPointwise(), img.shape, **kw)(img, 41.8, 20.4)
    got = tdp.segment_volume_chunked(_TorchPointwise(), img, 41.8, 20.4, **kw)
    assert torch.equal(got, want) and len(torch.unique(want)) - 1 >= 2


def test_device_pipeline_defaults_to_the_card():
    """Without ``device`` the pipeline asks for CUDA, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tdp.make_device_pipeline(_TorchPointwise(), (8, 8, 8))


@pytest.mark.cuda
def test_cuda_device_pipeline_matches_cpu():
    """On the card (the CC's propagate kernel launched, the plain
    propagation barred): the pointwise model's instances equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    from skoots_tpu_torch.kernels import propagate as prop_mod

    img, _, _ = make_tubes(shape=(64, 64, 24), n_tubes=3, min_separation=12.0, seed=4)
    kw = dict(crop=(32, 32, 16), vector_scale=(4.0, 4.0, 2.0), embed_iterations=6)
    want = tdp.make_device_pipeline(_TorchPointwise(), img.shape, device="cpu", **kw)(
        img, 41.8, 20.4)
    saved = prop_mod.propagate_ref
    prop_mod.propagate_ref = None  # any call of the plain propagation fails
    try:
        run = tdp.make_device_pipeline(_TorchPointwise(), img.shape, **kw)
        got = run(img, 41.8, 20.4)
    finally:
        prop_mod.propagate_ref = saved
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
