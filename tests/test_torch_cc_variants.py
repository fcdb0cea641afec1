"""The port's CC variants against the JAX package's, on the CPU: the axis
sweeps (``_axis_run_max``) and the stepped CC's ``scans_per_round``
schedule, the sparse point-cloud CC (``label_components_sparse``), and both
engines' ``cc_impl="sparse"`` (the host engine's tiles with their dense
fallback, the chunked pipeline's whole-volume CC), with the thrifty
pipeline's CC dense whatever ``SKOOTS_CC_IMPL`` says, as JAX's. Labels and
``ok`` are compared for exact equality."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.infer import device_pipeline as jdp
from skoots_tpu.ops import flood_fill as jff
from skoots_tpu_torch.checkpoint import load_checkpoint
from skoots_tpu_torch.infer import device_pipeline as tdp
from skoots_tpu_torch.models import model_from_checkpoint
from skoots_tpu_torch.ops import flood_fill as tff

from test_torch_pipeline import SCALE, SHAPE, _JaxOut, _TorchOut, phantom  # noqa: F401
from test_torch_thrifty import hot  # noqa: F401

T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: one torch thread, so the suite's parallel
    workers do not contend for each op's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random(shape, density, seed):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.uint8)


# ------------------------------------------------------------- axis sweeps

@pytest.mark.parametrize("bg_labels", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_run_max_matches_jax(monkeypatch, axis, bg_labels):
    """Random runs along each axis, in slabs of 61 voxels (which split the
    volume across another axis); with labels on the background too, where
    JAX's segmented scan counts a background voxel in the segment it
    starts."""
    monkeypatch.setattr(tff, "SLAB_VOXELS", 61)
    rng = np.random.default_rng(axis)
    fg = rng.random((9, 24, 7)) > 0.4
    lab = rng.integers(1, 2**31 - 1, fg.shape).astype(np.int32)
    if not bg_labels:
        lab = np.where(fg, lab, 0).astype(np.int32)
    want = np.asarray(jax.jit(jff._axis_run_max, static_argnums=2)(
        jnp.asarray(lab), jnp.asarray(fg), axis))
    got = tff._axis_run_max(T(lab), T(fg), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full_like(got, -7)
    assert tff._axis_run_max(T(lab), T(fg.astype(np.uint8)), axis, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def _long_tube():
    m = np.zeros((60, 8, 6), np.uint8)
    m[:, 2:4, 1:3] = 1
    m[50:, 2, 1:5] = 1
    return m


@pytest.mark.parametrize("mask", ["sparse", "percolating", "tube"])
@pytest.mark.parametrize("props,jumps,max_rounds", [(2, 0, 64), (1, 1, 64), (1, 0, 2)])
def test_scan_schedule_matches_jax(mask, props, jumps, max_rounds):
    """One sweep round a dispatch: the labels, rounds and convergence of
    JAX's schedule (also when 2 rounds end it early), and at the fixpoint
    the dense labels."""
    m = {"sparse": _random((28, 24, 12), 0.3, 1), "percolating": _random((28, 24, 12), 0.5, 2),
         "tube": _long_tube()}[mask]
    kw = dict(rounds_per_dispatch=1, propagates_per_round=props, jumps_per_round=jumps,
              scans_per_round=1)
    jlab = jff.make_label_components_stepped(m.shape, propagate_impl="xla", **kw)
    tlab = tff.make_label_components_stepped(m.shape, **kw)
    want = np.asarray(jlab(jnp.asarray(m), max_rounds=max_rounds))
    got = tlab(T(m), max_rounds=max_rounds).numpy()
    np.testing.assert_array_equal(got, want)
    assert (tlab.last_rounds, tlab.last_converged) == (jlab.last_rounds, jlab.last_converged)
    if tlab.last_converged:
        np.testing.assert_array_equal(got, tff.label_components(T(m)).numpy())
    if mask == "tube":  # a whole run in one sweep: 2 rounds, the second idle
        assert tlab.last_rounds <= 2


def test_scans_env_override_matches_keyword(monkeypatch):
    m = _random((20, 16, 8), 0.4, 3)
    kw = dict(rounds_per_dispatch=1, propagates_per_round=1, jumps_per_round=0)
    keyword = tff.make_label_components_stepped(m.shape, scans_per_round=1, **kw)
    want = keyword(T(m)).numpy()
    monkeypatch.setenv("SKOOTS_CC_SCANS", "1")
    env = tff.make_label_components_stepped(m.shape, **kw)
    jenv = jff.make_label_components_stepped(m.shape, propagate_impl="xla", **kw)
    got = env(T(m)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jenv(jnp.asarray(m))))
    assert env.last_rounds == keyword.last_rounds == jenv.last_rounds


# --------------------------------------------------------------- sparse CC

def _sparse_cases():
    rng = np.random.default_rng(31)
    thin = np.zeros((64, 8, 8), np.uint8)
    thin[:60, 2, 3] = 1
    thin[59, 2:6, 3] = 1
    capacity = np.zeros((8, 8, 8), np.uint8)
    capacity[0, 0, :4] = 1
    return {
        "random": ((rng.random((24, 20, 16)) < 0.12).astype(np.uint8), 2048),
        "dense_random": ((rng.random((32, 32, 24)) < 0.25).astype(np.uint8), 8192),
        "long_thin": (thin, 256),
        "empty": (np.zeros((8, 8, 8), np.uint8), 64),
        "full": (np.ones((8, 8, 8), np.uint8), 512),      # edges over 4 n_max
        "overflow": ((rng.random((16, 16, 16)) < 0.5).astype(np.uint8), 64),
        "exact_capacity": (capacity, 4),
        "few_rounds": (thin, 256),
    }


SPARSE = _sparse_cases()


@pytest.mark.parametrize("connectivity", [26, 6])
@pytest.mark.parametrize("case", list(SPARSE))
def test_label_components_sparse_matches_jax(case, connectivity):
    mask, n_max = SPARSE[case]
    rounds = 1 if case == "few_rounds" else 32
    want, wok = jff.label_components_sparse(jnp.asarray(mask), n_max=n_max,
                                            max_rounds=rounds, connectivity=connectivity)
    got, ok = tff.label_components_sparse(T(mask), n_max=n_max, max_rounds=rounds,
                                          connectivity=connectivity)
    assert isinstance(ok, bool) and ok == bool(wok)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if ok:
        dense = tff.label_components(T(mask), connectivity=connectivity)
        np.testing.assert_array_equal(got.numpy(), dense.numpy())
    # a full cube's 26-neighbour edges overflow 4 n_max, its 6-neighbour ones do not
    assert ok == (case not in ("overflow", "few_rounds")
                  and (case, connectivity) != ("full", 26))


# ----------------------------------------------------------------- engines

def _tiles_with_a_full_one():
    """(64, 32, 32) under a (32, 32, 16) crop: 4 tiles of speckle and runs
    across the seams, one of them full (16,384 voxels: within the sparse
    capacity, its edges over four times it, so it falls back)."""
    m = _random((64, 32, 32), 0.12, 5)
    m[3, :, 9] = 1
    m[:, 20, 17] = 1
    m[32:, :, 16:] = 1
    return m


@pytest.mark.parametrize("wire_thrift", [True, False])
def test_efficient_flood_fill_sparse_tiles_match_jax(monkeypatch, wire_thrift):
    mask = _tiles_with_a_full_one()
    crop = (32, 32, 16)
    want = jff.efficient_flood_fill(mask, crop_size=crop, cc_impl="sparse",
                                    wire_thrift=wire_thrift)
    info = {}
    got = tff.efficient_flood_fill(mask, crop_size=crop, cc_impl="sparse", info=info,
                                   wire_thrift=wire_thrift, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert info["cc_tiles"] == {"sparse": 3, "dense": 1}
    dense_info = {}
    dense = tff.efficient_flood_fill(mask, crop_size=crop, wire_thrift=wire_thrift,
                                     info=dense_info, device="cpu")
    np.testing.assert_array_equal(got, dense)
    assert dense_info["cc_tiles"] == {"sparse": 0, "dense": 4}
    assert 0 < info["rounds"] < dense_info["rounds"]
    monkeypatch.setenv("SKOOTS_CC_IMPL", "sparse")
    env_info = {}
    np.testing.assert_array_equal(
        tff.efficient_flood_fill(mask, crop_size=crop, wire_thrift=wire_thrift,
                                 info=env_info, device="cpu"), want)
    assert env_info["cc_tiles"] == info["cc_tiles"]


@pytest.mark.parametrize("variant", [dict(cc_impl="sparse"), dict(cc_scans_per_round=1)])
def test_chunked_cc_variants_match_jax_given_forward(phantom, variant):  # noqa: F811
    """The forward output injected into both pipelines: the sparse CC and
    the sweep schedule give JAX's instances, and the dense run's. The
    dilated tubes fill 13% of this small volume, so the sparse CC's edges
    overflow ``4 * cc_n_max`` and both packages fall back to the dense CC."""
    _, out = phantom
    kw = dict(crop=SHAPE, overlap=(0, 0, 0), assign_crop=(24, 24, 16), vector_scale=SCALE,
              embed_iterations=10, embed_compact_div=16, cc_rounds=24,
              cc_propagates_per_round=8, cc_jumps_per_round=1, dilation_3d=1,
              dilation_2d=2)
    vol = np.zeros(SHAPE, np.float32)
    jrun = jdp.make_chunked_pipeline(_JaxOut(), SHAPE, **kw, **variant)
    want = np.asarray(jrun(jnp.asarray(out), jnp.asarray(vol), 0.0, 1.0))
    trun = tdp.make_chunked_pipeline(_TorchOut(out), SHAPE, device="cpu", **kw, **variant)
    got = trun(vol, 0.0, 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    dense = tdp.make_chunked_pipeline(_TorchOut(out), SHAPE, device="cpu", **kw)
    np.testing.assert_array_equal(got, dense(vol, 0.0, 1.0).numpy())
    assert len(np.unique(want)) - 1 >= 3
    assert trun.last_cc_impl == "dense"
    if "cc_scans_per_round" in variant:
        assert trun.last_cc_rounds == jrun.last_cc_rounds < dense.last_cc_rounds


def _tiny_model(hot):  # noqa: F811
    ckpt, img = hot
    model = model_from_checkpoint(load_checkpoint(ckpt), device="cpu")
    knobs = dict(crop=(32, 32, 8), overlap=(0, 0, 0), assign_crop=(32, 32, 8),
                 vector_scale=(4.0, 4.0, 2.0), embed_compact_div=16,
                 dilation_3d=1, dilation_2d=2, device="cpu")
    return model, img, float(img.mean()), float(img.std()), knobs


def test_chunked_cc_variants_give_the_dense_mask(hot, monkeypatch):  # noqa: F811
    """The tiny f32 checkpoint through the chunked pipeline: ``cc_impl=
    "sparse"``, ``SKOOTS_CC_IMPL=sparse``, the sparse CC overflowing (the
    dense fallback, JAX's rule) and one sweep a round give the dense
    run's mask; ``last_cc_impl`` says which engine ran."""
    model, img, mean, std, knobs = _tiny_model(hot)
    base = tdp.make_chunked_pipeline(model, img.shape, **knobs)
    want = base(img, mean, std).numpy()
    assert base.last_cc_impl == "dense" and len(np.unique(want)) - 1 >= 4
    runs = {"keyword": tdp.make_chunked_pipeline(model, img.shape, cc_impl="sparse", **knobs),
            "scans": tdp.make_chunked_pipeline(model, img.shape, cc_scans_per_round=1,
                                               **knobs)}
    monkeypatch.setenv("SKOOTS_CC_IMPL", "sparse")
    runs["env"] = tdp.make_chunked_pipeline(model, img.shape, **knobs)
    runs["env_over_keyword"] = tdp.make_chunked_pipeline(model, img.shape,
                                                              cc_impl="dense", **knobs)
    runs["fallback"] = tdp.make_chunked_pipeline(model, img.shape, cc_impl="sparse", **knobs)
    real = tff.label_components_sparse

    def overflowing(b, n_max):  # a capacity the mask overflows
        out = real(b, n_max=64)
        overflowing.last_stats = real.last_stats
        return out

    engines = {}
    for name, run in runs.items():
        if name == "fallback":
            monkeypatch.setattr(tdp, "label_components_sparse", overflowing)
        np.testing.assert_array_equal(run(img, mean, std).numpy(), want)
        engines[name] = run.last_cc_impl
    assert engines == {"keyword": "sparse", "scans": "dense", "env": "sparse",
                       "env_over_keyword": "sparse", "fallback": "dense"}
    assert runs["fallback"].last_sparse_cc["ok"] is False
    assert runs["keyword"].last_sparse_cc["points"] > 64 and runs["scans"].last_sparse_cc is None


def test_thrifty_cc_stays_dense_under_sparse_env(hot, monkeypatch):  # noqa: F811
    """JAX's thrifty pipeline takes no ``cc_impl`` and always runs the
    dense stepped CC; so does the port's, also under
    ``SKOOTS_CC_IMPL=sparse`` (which made it raise before)."""
    assert "cc_impl" not in inspect.signature(tdp.make_thrifty_pipeline).parameters
    assert "cc_impl" not in inspect.signature(jdp.make_thrifty_pipeline).parameters
    model, img, mean, std, knobs = _tiny_model(hot)
    want = tdp.make_thrifty_pipeline(model, img.shape, **knobs)(img, mean, std)
    monkeypatch.setenv("SKOOTS_CC_IMPL", "sparse")
    run = tdp.make_thrifty_pipeline(model, img.shape, **knobs)
    got = run(img, mean, std)
    assert torch.equal(tff.widen_u16(got), tff.widen_u16(want))
    assert run.last_cc_rounds > 0 and int(tff.widen_u16(want).max()) >= 4
