"""Every width and kernel size the JAX package's kernels take, in the port.

JAX's fused block tail and LN head take every ``C % 8 == 0, C <= 256``
(its model runs XLA's composition elsewhere), and its schema every odd
``KERNEL_SIZE >= 3``. Here, on the same seeded numpy inputs: the port's
width rule against JAX's, the plain tail and LN head against the Pallas
kernels (``interpret=True``) at ragged widths, a block at a width no
kernel takes against JAX's composition, the accuracy campaign's model
against the flax model, and the plain depthwise conv and its weight
gradient at k = 9 against JAX's. The CUDA kernels at these shapes are
held to the plain versions on the card (``tests/test_torch_train_cuda.py``,
``tests/test_torch_infer_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.kernels import dwconv as D
from skoots_tpu.kernels.lnhead import _ln_head_call
from skoots_tpu.kernels.lnhead import ln_head_eligible as jax_ln_head_eligible
from skoots_tpu.kernels.mlp import _mlp_call
from skoots_tpu.kernels.mlp import mlp_tail_eligible as jax_mlp_tail_eligible
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu.models.unext import ConvNeXtBlock3D as JaxBlock
from skoots_tpu_torch import config as C
from skoots_tpu_torch.checkpoint import torch_params_from_flax
from skoots_tpu_torch.kernels.dwconv import (_check_conv_operands, dwconv3d, dwconv3d_ref,
                                             dwconv3d_wgrad_ref)
from skoots_tpu_torch.kernels.lnhead import ln_head_eligible, ln_head_ref
from skoots_tpu_torch.kernels.mlp import mlp_block_tail_ref, mlp_tail_eligible
from skoots_tpu_torch.models import cfg_to_model, load_flax_params
from skoots_tpu_torch.models import unext as U

T = torch.from_numpy
WIDTHS = [8, 16, 24, 48, 256]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_width_rule_is_jaxs():
    """For C = 1 ... 300 on a volume that passes JAX's volume conditions
    (V = 4096: a row tile divides it, V >= 512), the port's rule is JAX's."""
    for c in range(1, 301):
        x = np.broadcast_to(np.float32(0), (1, 16, 16, 16, c))
        assert mlp_tail_eligible(c) == jax_mlp_tail_eligible(x), c
        assert ln_head_eligible(c) == jax_ln_head_eligible(x), c


def _mlp_inputs(rng, v, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(v, c), f(v, c), f(c) * 0.1 + 1.0, f(c) * 0.1,
            f(c, 4 * c) * 0.1, f(4 * c) * 0.1, f(4 * c, c) * 0.1, f(c) * 0.1,
            np.full(c, 0.9, np.float32))


@pytest.mark.parametrize("c", WIDTHS)
def test_tail_ref_matches_pallas_at_width(rng, c):
    """At f32 (every rounding point the identity), as
    ``tests/test_torch_kernels.py`` holds the main widths: the bound of
    ``tests/test_pallas_mlp.py``, the Pallas kernel's A&S erf against the
    exact erf and sums in another order."""
    args = _mlp_inputs(rng, 256, c)
    want = np.asarray(_mlp_call(*map(jnp.asarray, args), interpret=True))
    got = mlp_block_tail_ref(*map(T, args)).numpy()
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=1e-3)


@pytest.mark.parametrize("c,n", [(c, c) for c in WIDTHS] + [(48, 200), (16, 256)])
def test_ln_head_ref_matches_pallas_at_width(rng, c, n):
    """f32 throughout, sums in another order only: 1e-5, as the main
    widths' test."""
    x = rng.standard_normal((512, c)).astype(np.float32)
    ls = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    lb = (rng.standard_normal(c) * 0.1).astype(np.float32)
    w = (rng.standard_normal((c, n)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want = np.asarray(_ln_head_call(*map(jnp.asarray, (x, ls, lb, w, b)), interpret=True))
    got = ln_head_ref(*map(T, (x, ls, lb, w, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _block_pair(rng, dim, dtype=jnp.float32):
    jb = JaxBlock(dim, 3, 1.0, 0.0, "gelu", dtype)
    x = rng.standard_normal((1, 8, 8, 4, dim)).astype(np.float32)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.2, jnp.float32), params)
    tb = U.ConvNeXtBlock3D(dim, 3, 1.0, 0.0, "gelu",
                           torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    sd = {k.removeprefix("b."): v for k, v in
          torch_params_from_flax({"params": {"b": params["params"]}}).items()}
    tb.load_state_dict(sd, strict=True)
    return jb, params, tb.eval(), x


@pytest.mark.parametrize("dim,fused", [(12, False), (20, False), (16, True)])
def test_block_routes_by_width_as_jax(rng, monkeypatch, dim, fused):
    """A block at a width the fused tail does not take (12, 20) runs flax's
    plain composition, as JAX's block does there; at one it takes (16) the
    fused tail. f32, within 2e-5 of JAX's block (sums in other orders); at
    bf16 the output is exactly the plain composition's (or the kernel's
    plain version's) on the block's own depthwise conv."""
    calls = []
    real = U.mlp_block_tail
    monkeypatch.setattr(U, "mlp_block_tail", lambda *a: calls.append(1) or real(*a))
    jb, params, tb, x = _block_pair(rng, dim)
    want = np.asarray(jb.apply(params, jnp.asarray(x), deterministic=True))
    got = tb(T(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert bool(calls) == fused
    tb16 = U.ConvNeXtBlock3D(dim, 3, 1.0, 0.0, "gelu", torch.bfloat16).eval()
    tb16.load_state_dict(tb.state_dict())
    with torch.no_grad():
        xb = T(x).to(torch.bfloat16)
        h = tb16.dwconv(xb)
        if fused:
            ref = mlp_block_tail_ref(h, xb, tb16.norm.weight, tb16.norm.bias,
                                     tb16.pw1.weight, tb16.pw1.bias, tb16.pw2.weight,
                                     tb16.pw2.bias, tb16.gamma)
        else:
            ref = tb16.plain_tail(h, xb)
        assert torch.equal(tb16(xb), ref)


def _campaign_models(rng, dims=(16, 32, 64, 32, 16)):
    """The accuracy campaign's model (``tools/accuracy_campaign.py``:
    widths 16-32-64-32-16, depth 1, k 7, 16 output channels) at f32 in both
    packages, JAX's random weights carried across."""
    m = {"DIMS": list(dims), "DEPTHS": [1] * len(dims), "KERNEL_SIZE": 7,
         "OUT_CHANNELS": dims[-1], "DTYPE": "float32"}
    jc = jax_defaults()
    jc.defrost()
    for k, v in m.items():
        setattr(jc.MODEL, k, v)
    tc = C.get_cfg_defaults()
    tc["MODEL"].update(m)
    jm, params = jax_init_model(jc, jax.random.PRNGKey(0), spatial=(16, 16, 8))
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.2, jnp.float32), params)
    tm = load_flax_params(cfg_to_model(tc), jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("dims", [(16, 32, 64, 32, 16), (12, 24, 12)],
                         ids=["campaign", "width12"])
def test_campaign_model_matches_flax(rng, dims):
    """f32 throughout, sums in other orders: within 2e-5 (as
    ``tests/test_torch_model.py``). At 12-24-12 the blocks at 12 and the
    head run flax's composition, the block at 24 the fused tail's plain
    version, as in JAX's model."""
    jm, params, tm = _campaign_models(rng, dims)
    x = rng.standard_normal((1, 16, 16, 8, 1)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        got = tm(T(x)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 8, 5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_head_routes_by_width(rng, monkeypatch):
    """The final head runs the fused LN head only where its width rule
    holds (16 and 24 here); at 12 flax's LayerNorm and 1x1 conv."""
    calls = []
    real = U.ln_head
    monkeypatch.setattr(U, "ln_head", lambda *a: calls.append(a[0].shape[-1]) or real(*a))
    for dims in ((16, 32, 16), (24, 48, 24), (12, 24, 12)):
        m = U.UNeXT3D(1, 8, dims, (1, 1, 1), 3, dtype=torch.float32).eval()
        with torch.no_grad():
            m(torch.zeros(1, 8, 8, 4, 1))
    assert calls == [16, 24]


def test_dwconv_ref_matches_jax_at_k9(rng):
    """k = 9 (JAX's schema takes any odd k): the plain depthwise conv
    against JAX's XLA reference, and the stem's one-channel broadcast; f32
    sums of 729 products in another order, 1e-4."""
    k, c = 9, 16
    x = rng.standard_normal((1, 10, 9, 12, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(D._xla_dwconv_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(dwconv3d_ref(T(x), T(w), T(b)).numpy(), want,
                               atol=1e-4, rtol=1e-4)
    x1 = x[..., :1]
    want1 = np.asarray(D._xla_dwconv_ref(jnp.asarray(np.broadcast_to(x1, x.shape)),
                                         jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(dwconv3d_ref(T(x1), T(w), T(b)).numpy(), want1,
                               atol=1e-4, rtol=1e-4)


def test_dwconv_grads_match_jax_at_k9(rng):
    """k = 9: the plain weight gradient, and the autograd of the whole
    wrapper (input gradient: the forward on the cotangent with flipped
    taps; weight gradient: the plain one), against JAX's XLA vjp; f32 sums
    in another order, 1e-4 (as the k = 7 tests of
    ``tests/test_torch_train_kernels.py``)."""
    k, c = 9, 32
    x = rng.standard_normal((2, 8, 8, 10, c)).astype(np.float32)
    g = rng.standard_normal((2, 8, 8, 10, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = np.zeros(c, np.float32)
    _, vjp = jax.vjp(lambda x_, w_: D._xla_dwconv_ref(x_, w_, jnp.asarray(b)),
                     jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(dwconv3d_wgrad_ref(T(x), T(g), k).numpy(), want_w,
                               atol=1e-4, rtol=1e-4)
    xt, wt = T(x).requires_grad_(), T(w).requires_grad_()
    dx, dw = torch.autograd.grad(dwconv3d(xt, wt, T(b)), (xt, wt), T(g))
    np.testing.assert_allclose(dx.numpy(), want_x, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dw.numpy(), want_w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k,ok", [(1, False), (2, False), (4, False), (3, True),
                                  (9, True), (11, True), (13, True)])
def test_kernels_take_every_odd_k(k, ok):
    """The operand check in front of the forward and weight-gradient
    launches takes every odd k >= 3 and refuses the rest."""
    x = torch.zeros((1, 4, 4, 4, 8), dtype=torch.bfloat16)
    if ok:
        _check_conv_operands("dwconv3d", x, 8, k)
    else:
        with pytest.raises(ValueError):
            _check_conv_operands("dwconv3d", x, 8, k)
