"""The port's whole-volume inference path (``skoots_tpu_torch.infer``)
against the JAX package's, on the CPU.

Given the same forward output, every post-forward stage is EXACT: the
dilation masks, the connected-component labels, the embedding walk and the
fg-compacted assignment (with its tile-local walk clamp) are compared bit
for bit. With a real model in the loop (a tiny f32 config, and the bench
checkpoint through both CLIs) the two forwards differ by float rounding,
so the bar there is the same instance count and every instance matched at
IoU >= 0.95.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.cli import main as jax_cli
from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.infer import device_pipeline as jdp
from skoots_tpu.infer.autoknobs import derive_dilation as jax_derive_dilation
from skoots_tpu.infer.engine import _probe_dilation as jax_probe_dilation
from skoots_tpu.models import init_model
from skoots_tpu.ops.flood_fill import make_label_components_stepped as jax_cc
from skoots_tpu.ops.morphology import binary_dilation, binary_dilation_2d
from skoots_tpu.ops.vec2embed import vector_to_embedding as jax_walk
from skoots_tpu.utils.io import imread as jax_imread
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu.utils.synthetic import make_tubes, perfect_prediction
from skoots_tpu_torch.cli import main as torch_cli
from skoots_tpu_torch.infer import device_pipeline as tdp
from skoots_tpu_torch.infer.autoknobs import derive_dilation
from skoots_tpu_torch.infer.engine import _probe_dilation
from skoots_tpu_torch.models import cfg_to_model, load_flax_params
from skoots_tpu_torch.ops.flood_fill import make_label_components_stepped
from skoots_tpu_torch.ops.vec2embed import fma, vector_to_embedding

SHAPE = (48, 48, 24)
SCALE = (12.0, 12.0, 6.0)  # the bench checkpoint's VECTOR_SCALING
T = torch.from_numpy


@pytest.fixture(scope="module")
def phantom():
    """(image u8, ideal 5-channel forward output with noisy probability
    channels) of a four-tube volume."""
    img, lab, sk = make_tubes(shape=SHAPE, n_tubes=4, min_separation=14.0,
                              seed=3)
    out = perfect_prediction(lab, sk, vector_scale=SCALE)
    noise = np.random.default_rng(0).uniform(0.0, 0.3, SHAPE + (2,))
    out[..., 3:5] = np.clip(out[..., 3:5] * 0.85 + noise, 0.0, 1.0)
    return img, out.astype(np.float32)


def _jax_tile_masks(out, thr, sem_thr, d3, d2):
    """The phase-1 tile decisions as ``device_pipeline.phase1_chunk``
    composes them."""
    out = jnp.asarray(out)
    vec, skel, prob = out[..., 0:3], out[..., 3:4], out[..., 4:5]
    keep = (prob > thr).astype(out.dtype)
    s5 = (skel * keep)[None]
    for _ in range(d3):
        s5 = binary_dilation(s5)
    for _ in range(d2):
        s5 = binary_dilation_2d(s5)
    skel_u8 = (s5[0, ..., 0] > thr).astype(jnp.uint8)
    sem_u8 = (prob[..., 0] > sem_thr).astype(jnp.uint8)
    return tuple(np.asarray(a) for a in (vec * keep, skel_u8, sem_u8))


@pytest.mark.parametrize("d3,d2,sem_thr", [(1, 2, 0.8), (0, 1, 0.9), (2, 0, 0.8)])
def test_tile_masks_match_jax(phantom, d3, d2, sem_thr):
    _, out = phantom
    want = _jax_tile_masks(out, 0.8, sem_thr, d3, d2)
    got = tdp.tile_masks(T(out), 0.8, sem_thr, d3, d2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)  # exact
    assert want[1].sum() > 0 and want[2].sum() > 0


def _speckle():
    return (np.random.default_rng(1).random((32, 32, 32)) < 0.3).astype(np.uint8)


@pytest.mark.parametrize("volume", ["tubes", "speckle"])
@pytest.mark.parametrize("props,jumps,conn", [(8, 1, 26), (6, 0, 26), (5, 1, 6)])
def test_cc_labels_match_jax(phantom, volume, props, jumps, conn):
    """Exact labels, the same round count, and convergence on both sides:
    4 propagates per kernel call plus the plain remainder (6, 5), with and
    without the pointer jump, 26- and 6-connectivity."""
    if volume == "tubes":
        mask = _jax_tile_masks(phantom[1], 0.8, 0.8, 1, 2)[1]
    else:
        mask = _speckle()
    jlab = jax_cc(mask.shape, rounds_per_dispatch=1, connectivity=conn,
                  propagates_per_round=props, jumps_per_round=jumps,
                  propagate_impl="xla")
    tlab = make_label_components_stepped(
        mask.shape, rounds_per_dispatch=1, connectivity=conn,
        propagates_per_round=props, jumps_per_round=jumps)
    want = np.asarray(jlab(jnp.asarray(mask), max_rounds=96))
    got = tlab(T(mask), max_rounds=96).numpy()
    np.testing.assert_array_equal(got, want)
    assert jlab.last_converged and tlab.last_converged
    assert tlab.last_rounds == jlab.last_rounds
    assert len(np.unique(want)) > 2


def test_fma_rounds_once_like_xla():
    """XLA on the CPU contracts the walk's ``p + v * s`` into one fused
    multiply-add; the port's ``fma`` rounds once too. The last triple is a
    double-rounding trap: a*b + c = 2^24 + 3 - 2^-46 lies just below a tie,
    so a plain f64 sum (2^24 + 3, the tie) would round to 2^24 + 4."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096).astype(np.float32) * 10 ** k
               for k in (0, -3, 2))
    a = np.append(a, np.float32(1 + 2 ** -23))
    b = np.append(b, np.float32(1 - 2 ** -23))
    c = np.append(c, np.float32(2 ** 24 + 2))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma(T(a), T(b), T(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == np.float32(2 ** 24 + 2)
    assert (got != (a * b + c)).any()  # the separately rounded product differs


@pytest.mark.parametrize("mode", ["dense", "compact", "early", "cycle", "decay"])
def test_walk_matches_jax(phantom, mode):
    _, out = phantom
    vec = (out[..., 0:3] * (out[..., 4:5] > 0.8))[None]
    kw = {"dense": {}, "compact": {"compact_div": 4},
          "early": {"exit_fraction": 1e-3},
          "cycle": {"exit_fraction": 1e-3, "exit_cycle": True},
          "decay": {"decay": 0.9}}[mode]
    want = np.asarray(jax_walk(SCALE, jnp.asarray(vec), n=10, **kw))
    got = vector_to_embedding(SCALE, T(vec), n=10, **kw).numpy()
    np.testing.assert_array_equal(got, want)  # exact: same f32 op chain


@pytest.fixture(scope="module")
def cc_labels(phantom):
    mask = _jax_tile_masks(phantom[1], 0.8, 0.8, 1, 2)[1]
    return np.asarray(jax_cc(SHAPE, rounds_per_dispatch=1,
                             propagates_per_round=8)(jnp.asarray(mask)))


@pytest.mark.parametrize("a_crop,origin", [((24, 24, 16), (24, 0, 8)),
                                           ((16, 16, 8), (16, 32, 16))])
def test_compact_assign_tile_matches_jax(phantom, cc_labels, a_crop, origin):
    """The fg-compacted assignment of one tile: the walk is clamped to the
    tile (``device_pipeline.py:227``), so the labels depend on the assign
    crop; the port must reproduce that clamp exactly. A random field walks
    far, across the tile's faces."""
    _, out = phantom
    fg = out[..., 4] > 0.8
    vec = np.random.default_rng(5).uniform(-1, 1, SHAPE + (3,)).astype(
        np.float32) * fg[..., None]
    sl = tuple(slice(o, o + c) for o, c in zip(origin, a_crop))
    jfn = jdp.make_compact_assign_tile(a_crop, SHAPE, jnp.asarray(SCALE),
                                       10, 1.0, 2)
    want = np.asarray(jfn(jnp.asarray(vec[sl]), jnp.asarray(fg[sl]),
                          jnp.asarray(cc_labels), jnp.asarray(origin)))
    tfn = tdp.make_compact_assign_tile(a_crop, SHAPE, SCALE, 10, 1.0, "cpu")
    got = tfn(T(vec[sl]), T(fg[sl]), T(cc_labels), origin).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 0
    # the clamp matters here: the same voxels walked in the whole volume
    # land on other labels somewhere
    whole = jdp.make_compact_assign_tile(SHAPE, SHAPE, jnp.asarray(SCALE),
                                         10, 1.0, 1)
    free = np.asarray(whole(jnp.asarray(vec), jnp.asarray(fg),
                            jnp.asarray(cc_labels), jnp.zeros(3, jnp.int32)))
    assert (free[sl] != want).any()


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


@pytest.mark.parametrize("assign_crop,compact", [((24, 24, 16), 16),
                                                 ((24, 24, 16), None),
                                                 (None, 16)])
def test_pipeline_matches_jax_given_forward(phantom, assign_crop, compact):
    """make_chunked_pipeline end to end with the forward output injected
    into both: the instance volumes are identical."""
    _, out = phantom
    kw = dict(crop=SHAPE, overlap=(0, 0, 0), assign_crop=assign_crop,
              vector_scale=SCALE, embed_iterations=10,
              embed_compact_div=compact, cc_rounds=24,
              cc_propagates_per_round=8, cc_jumps_per_round=1,
              dilation_3d=1, dilation_2d=2)
    vol = np.zeros(SHAPE, np.float32)
    jrun = jdp.make_chunked_pipeline(_JaxOut(), SHAPE, **kw)
    want = np.asarray(jrun(jnp.asarray(out), jnp.asarray(vol), 0.0, 1.0))
    trun = tdp.make_chunked_pipeline(_TorchOut(out), SHAPE, device="cpu", **kw)
    got = trun(vol, 0.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) - 1 >= 3
    assert trun.last_cc_converged and trun.last_cc_rounds == jrun.last_cc_rounds
    assert set(trun.last_phase_s) == {"1-forward", "2-cc", "3-assign"}


def _pointwise_jax(x):
    """A stand-in forward computed voxel by voxel with exact f32 products
    only, so JAX and torch agree bit for bit on every tile."""
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


def test_pipeline_tiling_matches_jax(phantom):
    """Several forward tiles with overlap and reflect padding, an odd
    volume extent, and a multi-tile assign grid: exact."""
    img = phantom[0][:, :46, :22]
    shape = img.shape
    kw = dict(crop=(24, 24, 12), overlap=(4, 4, 2), assign_crop=(20, 20, 12),
              vector_scale=(4.0, 4.0, 2.0), embed_iterations=6,
              embed_compact_div=16, cc_rounds=32, cc_propagates_per_round=8,
              cc_jumps_per_round=1, dilation_3d=1, dilation_2d=1)
    jrun = jdp.make_chunked_pipeline(_JaxPointwise(), shape, **kw)
    want = np.asarray(jrun(None, jnp.asarray(img), 41.8, 20.4))
    got = tdp.make_chunked_pipeline(_TorchPointwise(), shape, device="cpu", **kw)(
        img, 41.8, 20.4).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) - 1 >= 2


def test_probe_dilation_matches_jax(phantom):
    """The auto-dilation probe (host-engine tile grid, no dilation) finds
    the same skeleton spacing and so the same stack."""
    vol = phantom[0][..., None]
    crop, ov = (48, 48, 20), (12, 12, 5)
    aniso = (1.0, 1.0, 3.0)
    want = jax_probe_dilation(_JaxPointwise(), None, 41.8, 20.4, 0.8, vol,
                              crop, ov, aniso)
    got = _probe_dilation(_TorchPointwise(), 41.8, 20.4, 0.8, vol, crop, ov,
                          aniso, torch.device("cpu"))
    assert want is not None and got == want
    assert derive_dilation(got, aniso) == jax_derive_dilation(want, aniso)


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


def test_tiny_model_pipeline_matches_jax():
    """A tiny f32 UNeXT with random weights through both pipelines (three
    forward tiles per axis pair, overlap): same instances at IoU >= 0.95."""
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 4], [1, 1, 1]
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 8, 3
    cfg.MODEL.DTYPE = "float32"
    cfg.freeze()
    model, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.5, jnp.float32),
        params)
    tm = load_flax_params(cfg_to_model(cfg.to_dict()),
                          jax.tree_util.tree_map(np.asarray, params))
    shape = (40, 40, 16)
    img, _, _ = make_tubes(shape=shape, n_tubes=3, min_separation=14.0, seed=2)
    vol = img.astype(np.float32)
    mean, std = float(vol.mean()), float(vol.std())
    kw = dict(crop=(24, 24, 12), overlap=(4, 4, 2), assign_crop=(32, 32, 16),
              vector_scale=(4.0, 4.0, 2.0), embed_iterations=4,
              embed_compact_div=16, cc_rounds=32, cc_propagates_per_round=6,
              cc_jumps_per_round=1, dilation_3d=0, dilation_2d=0,
              prob_threshold=0.6)
    want = np.asarray(jdp.make_chunked_pipeline(model, shape, **kw)(
        params, jnp.asarray(vol), mean, std))
    got = tdp.make_chunked_pipeline(tm, shape, device="cpu", **kw)(vol, mean, std).numpy()
    n_want, n_got, ious = _match_instances(want, got)
    print(f"instances jax {n_want} torch {n_got}; min IoU {min(ious):.4f}; "
          f"{int((want != got).sum())} voxels differ")
    assert n_want >= 5 and n_got == n_want
    assert min(ious) >= 0.95


def _straight_tubes(shape, segments, radius=5.0, zscale=3.0, seed=0):
    """u8 image and labels of straight tubes painted as ``make_tubes``
    paints its polylines (z distances scaled by ``zscale``, fg 160 over bg
    40, gaussian noise 12)."""
    grid = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                       indexing="ij")
    w = np.array([1.0, 1.0, zscale])
    lab = np.zeros(shape, np.int32)
    for i, (a, b) in enumerate(segments, 1):
        a, ab = np.asarray(a, float), np.subtract(b, a) * w
        rel = [(g - a[k]) * w[k] for k, g in enumerate(grid)]
        t = np.clip(sum(r * ab[k] for k, r in enumerate(rel)) / (ab @ ab), 0, 1)
        d2 = sum((r - t * ab[k]) ** 2 for k, r in enumerate(rel))
        lab[(d2 <= radius ** 2) & (lab == 0)] = i
    img = 40.0 + 120.0 * (lab > 0)
    img += np.random.default_rng(seed).normal(0.0, 12.0, shape)
    return np.clip(img, 0, 255).astype(np.uint8), lab


def test_cli_matches_jax_cli_on_bench_checkpoint(tmp_path):
    """``skoots --image`` through both CLIs' whole-volume device engines
    (``--engine device``; the port on ``--device cpu``) with the bench
    checkpoint at full width on three tubes 14-16 voxels apart.
    The dilation stack is given (one in-plane pass, which keeps tubes that
    close apart), so neither CLI runs its probe forwards; the probe is held
    to JAX's exactly in test_probe_dilation_matches_jax."""
    img, lab = _straight_tubes((48, 48, 16), [((10, 4, 8), (10, 44, 8)),
                                              ((26, 4, 8), (26, 44, 8)),
                                              ((40, 6, 7), (38, 42, 9))])
    common = ["--pretrained-checkpoint", "runs/bench_ckpt.skoots",
              "--dilate-3d", "0", "--dilate-2d", "1", "--log", "1"]
    for side in ("jax", "torch"):
        jax_imsave(str(tmp_path / f"{side}.tif"), img)
    jax_cli(["--image", str(tmp_path / "jax.tif"), "--engine", "device",
             "--spatial-shards", "0"] + common)
    assert torch_cli(["--image", str(tmp_path / "torch.tif"), "--engine", "device",
                      "--device", "cpu"] + common) == 0
    want = jax_imread(str(tmp_path / "jax_instance_mask.tif"))
    got = jax_imread(str(tmp_path / "torch_instance_mask.tif"))
    for name in ("_skoots_benchmark.txt", "_skoots_phases.json"):
        assert (tmp_path / f"torch{name}").exists()
    n_want, n_got, ious = _match_instances(want, got)
    print(f"instances jax {n_want} torch {n_got} (tubes {len(np.unique(lab)) - 1}); "
          f"IoUs {[round(i, 4) for i in ious]}")
    assert n_want == 3 and n_got == n_want
    assert min(ious) >= 0.95


@pytest.mark.parametrize("flag", [["--spatial-shards", "2"],
                                  ["--experimental", "--spatial-shards", "2"]])
def test_cli_unported_options_raise(tmp_path, flag):
    """Options the call cannot honour raise instead of being ignored, also
    through ``--experimental``'s tuned knobs: two spatial shards on the
    one device ``--device cpu`` names raise JAX's message."""
    vol = tmp_path / "v.tif"
    jax_imsave(str(vol), np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="needs that many devices, have 1"):
        torch_cli(["--image", str(vol), "--pretrained-checkpoint",
                   "runs/bench_ckpt.skoots", "--log", "0", "--device", "cpu"] + flag)
