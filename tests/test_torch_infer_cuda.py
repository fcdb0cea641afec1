"""The host-streaming slice's CUDA kernels on the card: the stepped CC's
one propagate launch per pass (the plain propagation never runs on a CUDA
tensor), the upsample kernel bit for bit against its plain version with
its autograd gradient, and the two microbenchmarks against theirs.

Imports no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_infer_cuda.py -m cuda

Every test needs a GPU and skips elsewhere.
"""

import numpy as np
import pytest
import torch

from skoots_tpu_torch.kernels import propagate as prop_mod
from skoots_tpu_torch.kernels.microbench import (
    SHAPE,
    fma_chain,
    fma_chain_ref,
    loadfma,
    loadfma_ref,
)
from skoots_tpu_torch.kernels.upsample import upsample2x, upsample2x_ref
from skoots_tpu_torch.ops.flood_fill import label_components, make_label_components_stepped


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _no_plain_propagation(*args, **kwargs):
    raise AssertionError("the plain propagation ran on the card")


@pytest.mark.cuda
def test_cuda_cc_launches_one_kernel_per_pass(cuda_device, monkeypatch):
    """6 and 3 propagation passes per round (not multiples of 4): one
    launch per pass, the labels those of the plain passes on the CPU."""
    monkeypatch.setattr(prop_mod, "propagate_ref", _no_plain_propagation)
    rng = np.random.default_rng(0)
    mask = (rng.random((24, 20, 16)) < 0.1).astype(np.uint8)
    want = make_label_components_stepped(mask.shape, rounds_per_dispatch=1,
                                         propagates_per_round=6, jumps_per_round=1)
    monkeypatch.undo()
    ref = want(torch.from_numpy(mask), max_rounds=32)
    monkeypatch.setattr(prop_mod, "propagate_ref", _no_plain_propagation)
    prop_mod.propagate.launches = 0
    got = want(torch.from_numpy(mask).to(cuda_device), max_rounds=32)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert prop_mod.propagate.launches == 6 * want.last_rounds
    prop_mod.propagate.launches = 0
    lab, converged = label_components(torch.from_numpy(mask).to(cuda_device),
                                      propagates_per_round=3, jumps_per_round=2,
                                      return_converged=True)
    torch.cuda.synchronize()
    assert converged and prop_mod.propagate.launches % 3 == 0
    assert prop_mod.propagate.launches > 0


@pytest.mark.cuda
def test_cuda_upsample_matches_plain_version(cuda_device):
    """Bit for bit at both dtypes, any B, unit dimensions and C = 4; the
    gradient equals the CPU's (the plain cascade's vjp on both)."""
    rng = np.random.default_rng(1)
    upsample2x.launches = 0
    shapes = [(1, 8, 8, 5, 128), (2, 6, 4, 8, 64), (1, 5, 1, 3, 4), (2, 1, 1, 1, 3)]
    for shape in shapes:
        x32 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(cuda_device, dt)
            got, want = upsample2x(x), upsample2x_ref(x)
            assert got.dtype == dt and torch.equal(got, want)
    x = x32.to(cuda_device).requires_grad_()
    g = torch.randn((2, 2, 2, 2, 3))
    (dx,) = torch.autograd.grad(upsample2x(x), x, g.to(cuda_device))
    xc = x32.clone().requires_grad_()
    (dxc,) = torch.autograd.grad(upsample2x(xc), xc, g)
    torch.cuda.synchronize()
    assert torch.equal(dx.cpu(), dxc)
    assert upsample2x.launches == 2 * len(shapes) + 1


@pytest.mark.cuda
def test_cuda_microbenchmarks_match_plain_versions(cuda_device):
    rng = np.random.default_rng(2)
    for dt in (torch.float32, torch.bfloat16):
        for chains in (1, 8):
            a = torch.from_numpy(rng.uniform(0.999, 1.001, (64, 128)).astype(np.float32))
            b = torch.from_numpy(rng.uniform(-1, 1, (64, 128)).astype(np.float32))
            a, b = a.to(cuda_device, dt), b.to(cuda_device, dt)
            assert torch.equal(fma_chain(a, b, 2, chains), fma_chain_ref(a, b, 2))
    buf = torch.from_numpy(rng.integers(-8, 9, SHAPE).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-8, 9, (1, 128)).astype(np.float32)).to(cuda_device)
    for dynamic in (False, True):
        for chains in (1, 8):
            got = loadfma(buf, w, dynamic, chains, reps=3)
            assert torch.equal(got, loadfma_ref(buf, w, dynamic, chains)[None].expand_as(got))
