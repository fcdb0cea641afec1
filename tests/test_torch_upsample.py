"""The port's 2x trilinear upsample (``kernels/upsample.py``) against the
JAX package's: the plain version against the Pallas kernel run as its own
tests run it (``interpret=True``) and against the XLA cascade, and the
autograd backward against ``jax.vjp`` of ``upsample2x_trilinear``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.upsample import (
    _pallas_impl,
    _xla_upsample,
    upsample2x_trilinear,
)
from skoots_tpu_torch.kernels.upsample import upsample2x, upsample2x_ref

# the shapes of tests/test_pallas_upsample.py
PALLAS_SHAPES = [(1, 8, 8, 8, 8), (1, 16, 8, 4, 16), (2, 8, 6, 10, 8),
                 (1, 4, 4, 24, 128), (1, 16, 16, 24, 16)]
# plus a unit dimension and C = 4 (the tiny test configs' width), which the
# Pallas kernel does not take (its gate wants C % 8 == 0 and every
# dimension >= 2): held against the XLA cascade the kernel computes
ALL_SHAPES = PALLAS_SHAPES + [(1, 5, 1, 3, 4)]


@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=str)
def test_upsample_ref_matches_pallas(shape):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = np.asarray(_pallas_impl(jnp.asarray(x), interpret=True))
    got = upsample2x_ref(torch.from_numpy(x)).numpy()
    # the tolerance of tests/test_pallas_upsample.py (the Pallas kernel
    # runs z first; the plain version x, y, z)
    np.testing.assert_allclose(got, want, atol=2e-6)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=str)
def test_upsample_bf16_matches_xla_cascade(shape):
    """At bf16 the same f32 cascade of bf16 inputs with weights 3/4, 1/4 and
    one rounding: equal to ``_xla_upsample`` value for value (a differing
    value would be counted and bounded at 1 ulp; none differs)."""
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    want = np.asarray(_xla_upsample(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = upsample2x_ref(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=str)
def test_upsample_grad_matches_jax_vjp(shape):
    rng = np.random.default_rng(9)
    x = rng.standard_normal(shape).astype(np.float32)
    b, xs, ys, zs, c = shape
    ct = rng.standard_normal((b, 2 * xs, 2 * ys, 2 * zs, c)).astype(np.float32)
    _, vjp = jax.vjp(upsample2x_trilinear, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    xt = torch.from_numpy(x).requires_grad_()
    out = upsample2x(xt)
    np.testing.assert_array_equal(out.detach().numpy(), upsample2x_ref(xt).detach().numpy())
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    # both are the transpose of the same linear cascade, summed in another
    # order: the tolerance of tests/test_pallas_upsample.py; so is autograd's
    # own transpose of the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    (auto,) = torch.autograd.grad(upsample2x_ref(xt), xt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=2e-6)


def test_upsample_cpu_tensor_takes_the_plain_version():
    upsample2x.launches = 0
    upsample2x(torch.zeros((1, 2, 2, 2, 4)))
    assert upsample2x.launches == 0
    with pytest.raises((ValueError, RuntimeError)):
        upsample2x(torch.zeros((1, 2, 2, 2, 4), device="meta"))
