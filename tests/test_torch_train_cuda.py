"""The training path's CUDA kernels on the card, against their plain
versions, and a train-mode backward through every kernel wrapper.

Imports no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py -m cuda

Every test needs a GPU and skips elsewhere.
"""

import numpy as np
import pytest
import torch

from skoots_tpu_torch.config import get_cfg_defaults
from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad, dwconv3d_wgrad_ref
from skoots_tpu_torch.models import init_model
from skoots_tpu_torch.ops.skeleton import pack_skeletons
from skoots_tpu_torch.tools.bench_train_kernels import WGRAD_CASES, bake_cases

T = torch.from_numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wgrad_and_bake_match_plain_versions(cuda_device):
    """The weight gradient within 1e-3 * max|plain| (f32 sums of the same
    products in another order), over a batch of 2, the stem's one input
    channel and a ragged tile edge; the bake exactly."""
    rng = np.random.default_rng(0)
    dev = cuda_device
    for cin, c, shape in ((32, 32, (2, 24, 16, 20)), (1, 32, (1, 16, 16, 8)),
                          (64, 64, (1, 8, 8, 8))):
        x = T(rng.standard_normal((*shape, cin)).astype(np.float32)).to(dev, torch.bfloat16)
        g = T(rng.standard_normal((*shape, c)).astype(np.float32)).to(dev, torch.bfloat16)
        got = dwconv3d_wgrad(x, g, 7)
        ref = dwconv3d_wgrad_ref(x, g, 7)
        assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
        again = dwconv3d_wgrad(x, g, 7)
        assert torch.equal(got, again)  # fixed-order block sums: run to run
    shape = (40, 24, 16)
    masks = T(rng.integers(0, 4, shape).astype(np.int32)).to(dev)
    skels = {i: (rng.random((700, 3)) * np.asarray(shape)).astype(np.float32)
             for i in (1, 2, 3)}
    p = pack_skeletons(skels, device=dev)
    for aniso in ((1.0, 1.0, 1.0), (1.0, 1.0, 3.0)):
        got = bake_skeleton_kernel(masks, p.points, p.ids, aniso)
        ref = bake_skeleton_ref(masks, p.points, p.ids, aniso)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,cin,c,dt", WGRAD_CASES, ids=[c[0] for c in WGRAD_CASES])
def test_cuda_wgrad_kernels_at_the_training_shapes(cuda_device, name, shape, cin, c, dt):
    """The tensor-core kernels (bf16: the stem's Hankel GEMM, the depthwise
    transposed band) and the FP32 one (f32) at the training levels and a
    ragged batch of 2: within 1e-3 * max|plain|, the same from run to run."""
    rng = np.random.default_rng(5)
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x = T(rng.standard_normal((*shape, cin)).astype(np.float32)).to(cuda_device, dtype)
    g = T((rng.standard_normal((*shape, c)) * 1e-3).astype(np.float32)).to(cuda_device, dtype)
    got = dwconv3d_wgrad(x, g, 7)
    ref = dwconv3d_wgrad_ref(x, g, 7)
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    assert torch.equal(got, dwconv3d_wgrad(x, g, 7))


@pytest.mark.cuda
def test_cuda_bake_lists_match_the_plain_version(cuda_device):
    """The bake's cases at the training crop (8 boxes with P = 256 and
    4,096, the sparse loss's all-foreground case, equidistant duplicates,
    40 ids a tile for the over-cap scan): bit for bit."""
    for name, masks, pts, ids in bake_cases(np.random.default_rng(0), np.random.default_rng(1)):
        m = masks.to(cuda_device)
        p, i = T(pts).to(cuda_device), T(ids).to(cuda_device)
        got = bake_skeleton_kernel(m, p, i, (1.0, 1.0, 3.0))
        ref = bake_skeleton_ref(m, p, i, (1.0, 1.0, 3.0))
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), name


@pytest.mark.cuda
def test_cuda_every_parameter_gets_a_finite_gradient(cuda_device):
    """A train-mode forward and backward of the bench widths on the card:
    every parameter's gradient exists and is finite, through all the
    kernels' wrappers; per block one forward, one input-gradient and one
    weight-gradient launch (the stem: no input gradient)."""
    cfg = get_cfg_defaults()
    cfg["MODEL"]["DEPTHS"] = [1, 1, 1, 1, 1]
    model = init_model(cfg, 0, device=cuda_device).train()
    dwconv3d.launches = dwconv3d_wgrad.launches = 0
    x = torch.randn((1, 32, 32, 16, 1), device=cuda_device)
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    assert dwconv3d_wgrad.launches == 6 and dwconv3d.launches == 6 + 5
