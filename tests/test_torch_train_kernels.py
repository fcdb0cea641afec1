"""The training path's kernels and ops in the port against the JAX package,
on the same seeded numpy inputs: the dwconv weight gradient and the
autograd backward of the dwconv, block-tail and LN-head wrappers against
the JAX ``custom_vjp`` rules, the skeleton bake against the Pallas kernel
(``interpret=True``, as the JAX package's own tests run it), and the
skeleton ops, losses and sigma schedule.

The CUDA kernels run only on a GPU: ``tests/test_torch_train_cuda.py``
compares each with its plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels import dwconv as D
from skoots_tpu.kernels.bake import bake_skeleton_pallas
from skoots_tpu.kernels.lnhead import _xla_ln_head
from skoots_tpu.kernels.mlp import _xla_tail
from skoots_tpu.ops.embed2prob import baked_embed_to_prob as jax_embed_to_prob
from skoots_tpu.ops.skeleton import average_baked_skeletons as jax_average
from skoots_tpu.ops.skeleton import bake_skeleton as jax_bake
from skoots_tpu.ops.skeleton import index_skeleton_by_embed as jax_index_by_embed
from skoots_tpu.ops.skeleton import pack_skeletons as jax_pack
from skoots_tpu.ops.skeleton import skeleton_to_mask as jax_skeleton_to_mask
from skoots_tpu.train import losses as JL
from skoots_tpu.train.sigma import Sigma as JaxSigma
from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad, dwconv3d_wgrad_ref
from skoots_tpu_torch.kernels.lnhead import ln_head, xla_ln_head
from skoots_tpu_torch.kernels.mlp import mlp_block_tail, xla_tail
from skoots_tpu_torch.ops.embed2prob import baked_embed_to_prob
from skoots_tpu_torch.ops.skeleton import (
    average_baked_skeletons,
    index_skeleton_by_embed,
    pack_skeletons,
    skeleton_to_mask,
)
from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
from skoots_tpu_torch.train import losses as TL
from skoots_tpu_torch.train.sigma import Sigma

T = torch.from_numpy


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ------------------------------------------------------------ dwconv wgrad

@pytest.mark.parametrize("version", ["v1", "v2"])
def test_wgrad_ref_matches_pallas(rng, version):
    k, c = 3, 32
    x = rng.standard_normal((1, 8, 8, 8, c)).astype(np.float32)
    g = rng.standard_normal((1, 8, 8, 8, c)).astype(np.float32)
    fn = D.dwconv3d_wgrad_pallas if version == "v1" else D.dwconv3d_wgrad_pallas_v2
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(g), k, interpret=True))
    got = dwconv3d_wgrad_ref(T(x), T(g), k).numpy()
    # sums of 512 f32 products in another order (tests/test_pallas_dwconv.py)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bsz", [1, 2])
def test_wgrad_ref_matches_xla_vjp_k7(rng, bsz):
    k, c = 7, 32
    x = rng.standard_normal((bsz, 8, 8, 16, c)).astype(np.float32)
    w = rng.standard_normal((k, k, k, c)).astype(np.float32)
    b = np.zeros(c, np.float32)
    g = rng.standard_normal((bsz, 8, 8, 16, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda w_: D._xla_dwconv_ref(jnp.asarray(x), w_, jnp.asarray(b)),
                     jnp.asarray(w))
    (want,) = vjp(jnp.asarray(g))
    got = dwconv3d_wgrad_ref(T(x), T(g), k).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_wgrad_ref_stem_reads_one_channel_for_all(rng):
    """The stem's weight gradient from its one input channel equals the
    gradient from the input broadcast across C (the convolution backend
    may sum a stride-0 view in another order: 1e-5)."""
    x = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    g = rng.standard_normal((1, 8, 8, 8, 16)).astype(np.float32)
    one = dwconv3d_wgrad_ref(T(x), T(g), 3)
    wide = dwconv3d_wgrad_ref(T(np.broadcast_to(x, g.shape).copy()), T(g), 3)
    torch.testing.assert_close(one, wide, rtol=1e-5, atol=1e-5)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX backward's Pallas entry points through interpret mode
    and select the Pallas weight gradient, as tests/test_pallas_dwconv.py."""
    real_wgrad, real_dgrad = D.dwconv3d_wgrad_pallas, D.dwconv3d_dgrad
    monkeypatch.setattr(D, "dwconv3d_wgrad_pallas",
                        lambda *a, **kw: real_wgrad(*a, interpret=True, **kw))
    monkeypatch.setattr(D, "dwconv3d_dgrad",
                        lambda *a, **kw: real_dgrad(*a, interpret=True, **kw))
    monkeypatch.setenv("SKOOTS_DWGRAD_IMPL", "pallas")


@pytest.mark.parametrize("data", ["integers", "normal"])
def test_dwconv_backward_matches_custom_vjp(rng, pallas_interpret, data):
    """dx, dw, db of the port's autograd wrapper against the JAX
    ``custom_vjp`` backward. On integer-valued data every product and sum
    is exact in f32, so all three agree exactly whatever the summation
    order; on normal data sums in another order bound them at 1e-4."""
    k, c = 3, 32
    shape = (1, 8, 8, 8, c)
    if data == "integers":
        x, w, b, g = (rng.integers(-3, 4, s).astype(np.float32)
                      for s in (shape, (k, k, k, c), (c,), shape))
    else:
        x, w, b, g = (rng.standard_normal(s).astype(np.float32)
                      for s in (shape, (k, k, k, c), (c,), shape))
    jdx, jdw, jdb = D._dwconv3d_bwd(tuple(map(jnp.asarray, (x, w, b))), jnp.asarray(g))
    xt, wt, bt = (T(a).requires_grad_() for a in (x, w, b))
    dwconv3d(xt, wt, bt).backward(T(g))
    if data == "integers":
        for got, want in ((xt.grad, jdx), (wt.grad, jdw), (bt.grad, jdb)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        for got, want in ((xt.grad, jdx), (wt.grad, jdw), (bt.grad, jdb)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_dwconv_backward_stem_and_no_input_grad(rng):
    """The stem (one input channel read for all C): dw equals the JAX
    vjp of the dense 1 -> C conv, dx is the sum over C of the broadcast
    input's gradient, and no dx is made when the input needs none."""
    k, c = 3, 8
    x = rng.standard_normal((1, 8, 8, 8, 1)).astype(np.float32)
    w = rng.standard_normal((k, k, k, c)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    g = rng.standard_normal((1, 8, 8, 8, c)).astype(np.float32)

    def dense(x_, w_, b_):
        return jax.lax.conv_general_dilated(
            x_, w_[:, :, :, None, :], (1, 1, 1), "SAME",
            dimension_numbers=("NHWDC", "HWDIO", "NHWDC")) + b_

    _, vjp = jax.vjp(dense, *map(jnp.asarray, (x, w, b)))
    jdx, jdw, jdb = vjp(jnp.asarray(g))
    xt, wt, bt = (T(a).requires_grad_() for a in (x, w, b))
    dwconv3d(xt, wt, bt).backward(T(g))
    for got, want in ((xt.grad, jdx), (wt.grad, jdw), (bt.grad, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    xt = T(x)
    wt = T(w).requires_grad_()
    out = dwconv3d(xt, wt, T(b))
    (gw,) = torch.autograd.grad(out, wt, T(g))
    assert xt.grad is None and gw.shape == w.shape


def test_dwconv_backward_rounds_to_the_compute_dtype(rng):
    """At bf16, dw and db round to bf16 before the f32 parameter, as JAX's
    ``wg(...).astype(w.dtype)``."""
    k, c = 3, 16
    x = T(rng.standard_normal((1, 8, 8, 8, c)).astype(np.float32)).to(torch.bfloat16)
    w = T(rng.standard_normal((k, k, k, c)).astype(np.float32)).requires_grad_()
    b = torch.zeros(c, requires_grad=True)
    g = T(rng.standard_normal((1, 8, 8, 8, c)).astype(np.float32)).to(torch.bfloat16)
    dwconv3d(x, w, b).backward(g)
    assert torch.equal(w.grad, dwconv3d_wgrad_ref(x, g, k).to(torch.bfloat16).float())
    assert torch.equal(b.grad, g.float().sum((0, 1, 2, 3)).to(torch.bfloat16).float())


# ---------------------------------------------------- block tail / LN head

def _tail_inputs(rng, c, shape=(2, 4, 4, 8)):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [f(*shape, c), f(*shape, c), f(c) * 0.1 + 1.0, f(c) * 0.1,
            f(c, 4 * c) * 0.2, f(4 * c) * 0.1, f(4 * c, c) * 0.1, f(c) * 0.1,
            f(c) * 0.5 + 1.0]


def _rnd_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _against_jax_vjp(rng, port_fn, port_comp, jax_fn, args, dtype, n_act):
    """Gradients of the port's wrapper for a seeded cotangent against
    ``jax.vjp`` of the JAX composition; ``n_act`` leading arguments are
    activations (in ``dtype``), the rest parameters (f32 holding ``dtype``
    values on the port's side, ``dtype`` on JAX's, as the model passes)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [_rnd_bf16(a) if dtype == torch.bfloat16 else a for a in args]
    jargs = [jnp.asarray(a, jdt) for a in args]
    if port_comp is xla_tail:  # the block passes gamma as the f32 parameter
        jargs[-1] = jnp.asarray(args[-1], jnp.float32)
    out, vjp = jax.vjp(jax_fn, *jargs)
    g = rng.standard_normal(out.shape).astype(np.float32)
    g = _rnd_bf16(g) if dtype == torch.bfloat16 else g
    want = vjp(jnp.asarray(g, out.dtype))
    targs = [(T(a).to(dtype) if i < n_act else T(a)).requires_grad_()
             for i, a in enumerate(args)]
    port_fn(*targs).backward(T(g).to(dtype))
    return [(t.grad.float().numpy(), _np(w)) for t, w in zip(targs, want)]


def _bf16_grad_bound(got, want):
    """bf16: the gradient of a bias or of gamma is a sum over every voxel
    of a bf16 cotangent product. XLA on the CPU accumulates that sum in
    bf16, torch in f32, so those leaves differ by ~2% of their norm (2^-8
    per rounding, over 256 terms); the other leaves agree to an ulp or two.
    Bound: max |d| <= 6e-2 max |want| and ||d|| <= 3e-2 ||want||."""
    d = got - want
    assert np.abs(d).max() <= 6e-2 * np.abs(want).max()
    assert np.linalg.norm(d) <= 3e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [32, 64])
def test_mlp_backward_matches_jax_vjp(rng, dtype, c):
    pairs = _against_jax_vjp(rng, mlp_block_tail, xla_tail, _xla_tail,
                             _tail_inputs(rng, c), dtype, 2)
    for got, want in pairs:
        scale = np.abs(want).max()
        if dtype == torch.float32:
            # f32 throughout: sums in another order only
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
        else:
            _bf16_grad_bound(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ln_head_backward_matches_jax_vjp(rng, dtype):
    c, n = 32, 32
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    args = [f(2, 4, 4, 8, c), f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, n) * 0.2, f(n) * 0.1]
    pairs = _against_jax_vjp(rng, ln_head, xla_ln_head, _xla_ln_head, args, dtype, 1)
    for got, want in pairs:
        scale = np.abs(want).max()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
        else:
            _bf16_grad_bound(got, want)


def test_backward_differentiates_the_composition_not_the_reference(rng):
    """The wrappers' gradients are exactly autograd of the XLA compositions
    on the saved inputs (the same check chip_smoke.py makes on the card)."""
    args = [T(a).requires_grad_() for a in _tail_inputs(rng, 32)]
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(mlp_block_tail(*args), args, g)
    want = torch.autograd.grad(xla_tail(*args), args, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------------- bake

def _bake_case(rng, shape=(24, 16, 8), n_inst=3, pts_per=5):
    masks = rng.integers(0, n_inst + 1, shape).astype(np.int32)
    skels = {i: rng.random((pts_per, 3)).astype(np.float32) * np.asarray(shape)
             for i in range(1, n_inst + 1)}
    return masks, skels


@pytest.mark.parametrize("aniso", [(1.0, 1.0, 1.0), (1.0, 1.0, 3.0)])
def test_bake_ref_matches_pallas(rng, aniso):
    masks, skels = _bake_case(rng)
    packed = jax_pack(skels)
    want_b, want_d = bake_skeleton_pallas(jnp.asarray(masks), packed.points, packed.ids,
                                          anisotropy=aniso, interpret=True)
    got_b, got_d = bake_skeleton_ref(T(masks), T(np.asarray(packed.points)),
                                     T(np.asarray(packed.ids)), aniso)
    # the Pallas test's bound (tests/test_pallas_bake.py)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-3)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-3)


def test_bake_ref_matches_pallas_many_points(rng):
    """1,500 points: three of the Pallas kernel's 512-point blocks."""
    masks = np.ones((8, 8, 8), np.int32)
    packed = jax_pack({1: rng.random((1500, 3)).astype(np.float32) * 8})
    want_b, want_d = bake_skeleton_pallas(jnp.asarray(masks), packed.points, packed.ids,
                                          interpret=True)
    got_b, got_d = bake_skeleton_ref(T(masks), T(np.asarray(packed.points)),
                                     T(np.asarray(packed.ids)))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-3)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-3)


@pytest.mark.parametrize("aniso", [(1.0, 1.0, 1.0), (1.0, 1.0, 3.0)])
def test_bake_ref_distances_match_mxu_path(rng, aniso):
    """Against the JAX package's MXU matmul path (``|c|^2 + |s|^2 - 2c.s``),
    which rounds differently: the distances agree to 1e-3."""
    masks, skels = _bake_case(rng)
    _, want_d = jax_bake(jnp.asarray(masks), jax_pack(skels), anisotropy=aniso,
                         average=False, return_distance=True, impl="mxu")
    p = pack_skeletons(skels)
    _, got_d = bake_skeleton_ref(T(masks), p.points, p.ids, aniso)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-3)


# ------------------------------------------------------------ skeleton ops

def test_average_baked_skeletons_matches_jax(rng):
    baked = rng.random((2, 8, 6, 5, 3)).astype(np.float32) * 10
    baked[rng.random(baked.shape) < 0.4] = 0
    want = np.asarray(jax_average(jnp.asarray(baked)))
    got = average_baked_skeletons(T(baked)).numpy()
    # window sums of 27 values in another order
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius,flank", [(3, 3), (7, 3)])
def test_skeleton_to_mask_matches_jax(rng, radius, flank):
    shape = (24, 20, 10)
    skels = {i: (rng.random((6, 3)) * (np.asarray(shape) + 8) - 4).astype(np.float32)
             for i in (1, 2, 5)}
    skels[2][0] = [3.5, 4.5, 2.5]  # half-way points round to even in both
    want = np.asarray(jax_skeleton_to_mask(jax_pack(skels), shape, radius, flank))
    got = skeleton_to_mask(pack_skeletons(skels), shape, radius, flank).numpy()
    np.testing.assert_array_equal(got, want)  # exact


def test_index_skeleton_by_embed_matches_jax(rng):
    skel = rng.integers(0, 5, (10, 8, 6)).astype(np.int32)
    emb = (rng.standard_normal((2, 4, 4, 3, 3)) * 8 + 4).astype(np.float32)
    emb[0, 0, 0, 0] = [2.5, 3.5, -0.5]  # half-way: both round half to even
    want = np.asarray(jax_index_by_embed(jnp.asarray(skel), jnp.asarray(emb)))
    got = index_skeleton_by_embed(T(skel), T(emb)).numpy()
    np.testing.assert_array_equal(got, want)  # exact


def test_baked_embed_to_prob_matches_jax(rng):
    emb = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32) * 5
    baked = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32) * 5
    sigma = np.asarray([8.0, 8.0, 4.0], np.float32)
    want = np.asarray(jax_embed_to_prob(jnp.asarray(emb), jnp.asarray(baked), sigma))
    got = baked_embed_to_prob(T(emb), T(baked), sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_embedding_walk_gradient_is_the_scale(rng):
    """The embedding loss trains through the walk's exact FMA step: its
    gradient w.r.t. the vectors is the scale."""
    v = T(rng.standard_normal((1, 4, 4, 3, 3)).astype(np.float32)).requires_grad_()
    vector_to_embedding((12.0, 12.0, 6.0), v).sum().backward()
    assert torch.equal(v.grad, torch.tensor([12.0, 12.0, 6.0]).expand_as(v))


# ------------------------------------------------------------------ losses

LOSSES = [
    ("tversky", ["alpha", "beta", "eps"], [0.25, 0.75, 1e-8]),
    ("dice", ["eps"], [1e-10]),
    ("jaccard", ["eps"], [1e-10]),
    ("soft_cldice", ["iters", "smooth"], [3, 1.0]),
    ("soft_dice_cldice", ["iters", "alpha", "smooth"], [2, 0.5, 1.0]),
]


@pytest.mark.parametrize("name,keys,vals", LOSSES, ids=[case[0] for case in LOSSES])
def test_losses_match_jax(rng, name, keys, vals):
    pred = rng.random((2, 10, 9, 6, 1)).astype(np.float32)
    gt = (rng.random((2, 10, 9, 6, 1)) > 0.6).astype(np.float32)
    want = float(JL.cfg_loss(name, keys, vals)(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(TL.cfg_loss(name, keys, vals)(T(pred), T(gt)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sigma_matches_jax():
    adj = [{"multiplier": 0.66, "epoch": 2}, {"multiplier": 0.5, "epoch": 5}]
    js, ts = JaxSigma(adj, (8.0, 8.0, 4.0)), Sigma(adj, (8.0, 8.0, 4.0))
    for e in range(8):
        np.testing.assert_array_equal(ts(e), js.host(e))
        np.testing.assert_array_equal(ts(e), np.asarray(js(e)))


# ---------------------------------------------------------------- wrappers

def _new_wrappers():
    return (dwconv3d_wgrad, bake_skeleton_kernel)


def test_cpu_tensors_take_the_plain_versions(rng):
    for fn in _new_wrappers():
        fn.launches = 0
    x = T(rng.standard_normal((1, 4, 4, 4, 8)).astype(np.float32))
    dwconv3d_wgrad(x, x, 3)
    bake_skeleton_kernel(torch.ones((4, 4, 4), dtype=torch.int32),
                         torch.zeros((2, 3)), torch.ones(2, dtype=torch.int32))
    assert [fn.launches for fn in _new_wrappers()] == [0, 0]


def test_other_devices_raise_instead_of_falling_back():
    x = torch.zeros((1, 4, 4, 4, 8), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        dwconv3d_wgrad(x, x, 3)
    with pytest.raises((ValueError, RuntimeError)):
        bake_skeleton_kernel(torch.ones((4, 4, 4), dtype=torch.int32, device="meta"),
                             torch.zeros((2, 3), device="meta"),
                             torch.ones(2, dtype=torch.int32, device="meta"))
