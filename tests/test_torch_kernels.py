"""Plain PyTorch versions of the port's four kernels against the Pallas
kernels they replace, run as the JAX package's own tests run them
(``interpret=True`` on the CPU), on the same seeded numpy inputs.

The CUDA kernels themselves run only on a GPU: the ``cuda``-marked tests at
the end compare each one with its plain version there and skip elsewhere
(``python -m pytest tests/test_torch_kernels.py -m cuda`` on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.dwconv import (
    dwconv3d_pallas,
    dwconv3d_pallas_v4,
    dwconv3d_pallas_v6,
)
from skoots_tpu.kernels.lnhead import _ln_head_call
from skoots_tpu.kernels.mlp import _mlp_call
from skoots_tpu.kernels.propagate import propagate_pallas
from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref
from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_ref
from skoots_tpu_torch.kernels.mlp import mlp_block_tail, mlp_block_tail_ref
from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref

T = torch.from_numpy


def _dw_inputs(rng, shape, k):
    c = shape[-1]
    x = rng.standard_normal((1, *shape)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, w, b


# (Pallas function, k, [X, Y, Z, C]): each TPU layout at a shape it takes
# (v4/v6: 128 % C == 0 and Z % (128 // C) == 0). k = 7 is the main path's;
# the v4/v6 interpreters take 10-30 s at k = 7, so they run at k = 3.
DW_CASES = [
    ("v4", dwconv3d_pallas_v4, 3, (8, 8, 8, 128)),
    ("v6", dwconv3d_pallas_v6, 3, (8, 8, 8, 128)),
    ("slab", dwconv3d_pallas, 3, (8, 8, 8, 128)),
    ("slab", dwconv3d_pallas, 7, (8, 8, 8, 128)),
    ("slab", dwconv3d_pallas, 7, (8, 8, 16, 32)),
]


@pytest.mark.parametrize("name,fn,k,shape", DW_CASES,
                         ids=[f"{c[0]}-k{c[2]}-{c[3]}" for c in DW_CASES])
def test_dwconv_ref_matches_pallas(rng, name, fn, k, shape):
    x, w, b = _dw_inputs(rng, shape, k)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         block=(8, 8), interpret=True))
    got = dwconv3d_ref(T(x), T(w), T(b)).numpy()
    # f32 sums of k^3 products in another order: 1e-3 as the JAX tests
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_dwconv_stem_broadcast_matches_pallas(rng):
    """The stem: one input channel read for all C outputs equals the
    depthwise conv of the explicitly broadcast input."""
    x, w, b = _dw_inputs(rng, (8, 8, 8, 128), 7)
    x1 = x[..., :1]
    want = np.asarray(dwconv3d_pallas(
        jnp.broadcast_to(jnp.asarray(x1), x.shape), jnp.asarray(w),
        jnp.asarray(b), block=(8, 8), interpret=True))
    got = dwconv3d_ref(T(x1), T(w), T(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def _mlp_inputs(rng, v, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(v, c), f(v, c), f(c) * 0.1 + 1.0, f(c) * 0.1,
            f(c, 4 * c) * 0.1, f(4 * c) * 0.1, f(4 * c, c) * 0.1, f(c) * 0.1,
            np.full(c, 0.9, np.float32))


@pytest.mark.parametrize("c", [16, 32, 64, 128])
def test_mlp_ref_matches_pallas(rng, c):
    """At f32, where every rounding point is the identity: XLA on the CPU
    drops the interpreter's intermediate bf16 casts, so a bf16 comparison
    would test XLA's float normalisation, not the kernel's function."""
    args = _mlp_inputs(rng, 256, c)
    want = np.asarray(_mlp_call(*map(jnp.asarray, args), interpret=True))
    got = mlp_block_tail_ref(*map(T, args)).numpy()
    # the bound of tests/test_pallas_mlp.py: the Pallas kernel's A&S erf
    # (|err| <= 1.5e-7) against exact erf, and sums in another order
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=1e-3)


@pytest.mark.parametrize("c,n", [(32, 32), (32, 8), (64, 32)])
def test_ln_head_ref_matches_pallas(rng, c, n):
    x = rng.standard_normal((512, c)).astype(np.float32)
    ls = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    lb = (rng.standard_normal(c) * 0.1).astype(np.float32)
    w = (rng.standard_normal((c, n)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want = np.asarray(_ln_head_call(*map(jnp.asarray, (x, ls, lb, w, b)),
                                    interpret=True))
    got = ln_head_ref(*map(T, (x, ls, lb, w, b))).numpy()
    # f32 throughout: sums in another order only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("connectivity", [26, 6])
def test_propagate_matches_pallas(rng, connectivity):
    shape = (16, 16, 128)
    fg = (rng.random(shape) > 0.5).astype(np.uint8)
    lab = np.where(fg > 0, np.arange(1, fg.size + 1, dtype=np.int32)
                   .reshape(shape), 0).astype(np.int32)
    want = np.asarray(propagate_pallas(jnp.asarray(lab), jnp.asarray(fg),
                                       passes=4, connectivity=connectivity,
                                       block_x=8, interpret=True))
    got = propagate(T(lab), T(fg), passes=4, connectivity=connectivity)
    np.testing.assert_array_equal(got.numpy(), want)  # exact
    one = propagate_ref(T(lab), T(fg), connectivity)
    for _ in range(3):
        one = propagate_ref(one, T(fg), connectivity)
    np.testing.assert_array_equal(one.numpy(), want)


def _all_wrappers():
    return (dwconv3d, mlp_block_tail, ln_head, propagate)


def _call_each(rng, device):
    x, w, b = _dw_inputs(rng, (4, 4, 4, 32), 3)
    dwconv3d(T(x).to(device), T(w).to(device), T(b).to(device))
    m = [T(a).to(device) for a in _mlp_inputs(rng, 64, 32)]
    mlp_block_tail(*m)
    ln_head(m[0], m[2], m[3], m[4][:, :32].contiguous(), m[7])
    lab = torch.arange(1, 65, dtype=torch.int32).view(4, 4, 4).to(device)
    propagate(lab, torch.ones_like(lab, dtype=torch.uint8), passes=4)


def test_cpu_tensors_take_the_plain_versions(rng):
    """A CPU tensor never reaches a kernel: every launch count stays 0
    (the counts are wrapper attributes the main path's run reads)."""
    for fn in _all_wrappers():
        fn.launches = 0
    _call_each(rng, "cpu")
    assert [fn.launches for fn in _all_wrappers()] == [0, 0, 0, 0]


def test_other_devices_raise_instead_of_falling_back(rng):
    """Only a CPU tensor takes the plain version; any other device must
    launch the kernel or raise (the meta device has no kernel)."""
    with pytest.raises((ValueError, RuntimeError)):
        _call_each(rng, "meta")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(rng, cuda_device):
    """On the card: every kernel launches and agrees with its plain version
    (dwconv and lnhead within 1 bf16 ulp, mlp at the Pallas test's bound,
    propagate exactly)."""
    bf = torch.bfloat16
    dev = cuda_device
    for fn in _all_wrappers():
        fn.launches = 0
    x, w, b = _dw_inputs(rng, (16, 16, 24, 32), 7)
    xd = T(x).to(dev, bf)
    wd, bd = T(w).to(dev).to(bf).float(), T(b).to(dev).to(bf).float()
    for xin in (xd, xd[..., :1].contiguous()):
        got = dwconv3d(xin, wd, bd).float()
        ref = dwconv3d_ref(xin, wd, bd).float()
        # one bf16 ulp of max(|ref|, rms(ref)): both round one f32 sum once
        scale = torch.maximum(ref.abs(), ref.square().mean().sqrt())
        ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
        assert bool(((got - ref).abs() <= ulp).all())
    m = [T(a).to(dev) for a in _mlp_inputs(rng, 4096, 64)]
    for i in (0, 1, 4, 6):
        m[i] = m[i].to(bf)
    got, ref = mlp_block_tail(*m).float(), mlp_block_tail_ref(*m).float()
    torch.testing.assert_close(got, ref, atol=4e-3, rtol=1e-3)
    hx = m[0][:, :32].contiguous()
    hw = m[4][:32, :32].contiguous()
    got = ln_head(hx, m[2][:32], m[3][:32], hw, m[7][:32])
    ref = ln_head_ref(hx, m[2][:32], m[3][:32], hw, m[7][:32])
    assert torch.equal(got, ref)
    fg = torch.rand((32, 32, 64), device=dev) < 0.4
    lab = torch.where(fg, torch.arange(1, fg.numel() + 1, device=dev,
                                       dtype=torch.int32).view(fg.shape), 0)
    want = lab
    for _ in range(4):
        want = propagate_ref(want, fg)
    assert torch.equal(propagate(lab, fg, passes=4), want)
    torch.cuda.synchronize()
    assert [fn.launches for fn in _all_wrappers()] == [2, 1, 1, 4]
