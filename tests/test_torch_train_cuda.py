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
from skoots_tpu_torch.kernels.dwconv import (dwconv3d, dwconv3d_wgrad, dwconv3d_wgrad_ref,
                                             dwconv3d_wgrad_route)
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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 7, 9, 11, 13, 15])
def test_cuda_wgrad_at_every_odd_k(cuda_device, k):
    """Every odd k, bf16 and f32, the depthwise layer and the stem's one
    input channel, over a ragged batch of 2, then the bf16 stems at C =
    16, 48, 256 on the stem GEMM their route names
    (``stem_wgrad_chunk_kernel<NT, k <= 7>``), then at k >= 9 the bf16
    depthwise layer at C = 16, 32, 48, 96, 256 on
    ``dwconv3d_wgrad_big_kernel<k>`` (f32: the run-time-k kernel) and at C
    = 12, 20 (and at k = 15 also C = 16, k = 17) on
    ``dwconv3d_wgrad_any_kernel<bf16>``: within 1e-3 * max|plain|, the same
    from run to run."""
    rng = np.random.default_rng(7 + k)
    for cin, c, shape in ((16, 16, (2, 13, 11, 9)), (1, 16, (1, 12, 10, 8)),
                          (64, 64, (1, 9, 8, 7))):
        for dtype in (torch.bfloat16, torch.float32):
            x = T(rng.standard_normal((*shape, cin)).astype(np.float32)).to(cuda_device, dtype)
            g = T(rng.standard_normal((*shape, c)).astype(np.float32)).to(cuda_device, dtype)
            got = dwconv3d_wgrad(x, g, k)
            ref = dwconv3d_wgrad_ref(x, g, k)
            assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max()), (cin, dtype)
            assert torch.equal(got, dwconv3d_wgrad(x, g, k))
    for c in (16, 48, 256):
        route = dwconv3d_wgrad_route(torch.bfloat16, 0, c, k)
        assert route.startswith("stem_wgrad_chunk_kernel<") and route.endswith(
            ",1>" if k <= 7 else ",0>"), (c, k, route)
        x = T(rng.standard_normal((2, 11, 18, 21, 1)).astype(np.float32))
        g = T(rng.standard_normal((2, 11, 18, 21, c)).astype(np.float32))
        x, g = x.to(cuda_device, torch.bfloat16), g.to(cuda_device, torch.bfloat16)
        got = dwconv3d_wgrad(x, g, k)
        ref = dwconv3d_wgrad_ref(x, g, k)
        assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max()), (c, k, route)
        assert torch.equal(got, dwconv3d_wgrad(x, g, k)), (c, k)
    if k <= 7:
        return
    # bf16 depthwise layers at k >= 9: dwconv3d_wgrad_big_kernel at every
    # width (one operand contiguous but off a 16-byte boundary: the wrapper
    # aligns it); f32 still on the run-time-k kernel
    for c in (16, 32, 48, 96, 256):
        assert dwconv3d_wgrad_route(torch.bfloat16, 1, c, k) == \
            f"dwconv3d_wgrad_big_kernel<{k}>", (c, k)
        assert dwconv3d_wgrad_route(torch.float32, 1, c, k) == \
            "dwconv3d_wgrad_any_kernel<float>", (c, k)
        shape = (2, 11, 21, 13, c) if c <= 48 else (1, 9, 18, 11, c)
        x = T(rng.standard_normal(shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
        g = T(rng.standard_normal(shape).astype(np.float32))
        if c == 48:
            flat = torch.empty(g.numel() + 1, device=cuda_device, dtype=torch.bfloat16)
            g = flat[1:].view(shape).copy_(g)
        else:
            g = g.to(cuda_device, torch.bfloat16)
        got = dwconv3d_wgrad(x, g, k)
        ref = dwconv3d_wgrad_ref(x, g, k)
        assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max()), (c, k)
        assert torch.equal(got, dwconv3d_wgrad(x, g, k)), (c, k)
    # the bf16 depthwise layers left to the run-time-k kernel: C off 8, k > 15
    for c, kk in [(12, k), (20, k)] + ([(16, 17)] if k == 15 else []):
        assert dwconv3d_wgrad_route(torch.bfloat16, 1, c, kk) == \
            "dwconv3d_wgrad_any_kernel<bf16>", (c, kk)
        x = T(rng.standard_normal((2, 11, 14, 13, c)).astype(np.float32))
        g = T(rng.standard_normal((2, 11, 14, 13, c)).astype(np.float32))
        x, g = x.to(cuda_device, torch.bfloat16), g.to(cuda_device, torch.bfloat16)
        got = dwconv3d_wgrad(x, g, kk)
        ref = dwconv3d_wgrad_ref(x, g, kk)
        assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max()), (c, kk)
        assert torch.equal(got, dwconv3d_wgrad(x, g, kk)), (c, kk)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,k", [((16, 32, 64, 32, 16), 7), ((24, 48, 24), 9),
                                    ((12, 24, 12), 3)])
def test_cuda_every_width_trains(cuda_device, dims, k):
    """A train-mode forward and backward at the accuracy campaign's widths
    (the tensor-core kernels at C = 16), at 24-48 with k = 9 (the
    width-class and run-time-k kernels) and at 12 (flax's composition
    where no kernel takes the width): every gradient finite; the block tail
    launched once a block whose width it takes, the LN head only where its
    width rule holds."""
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail

    cfg = get_cfg_defaults()
    cfg["MODEL"].update(DIMS=list(dims), DEPTHS=[1] * len(dims), KERNEL_SIZE=k,
                        OUT_CHANNELS=dims[-1])
    model = init_model(cfg, 0, device=cuda_device).train()
    dwconv3d.launches = dwconv3d_wgrad.launches = 0
    mlp_block_tail.launches = ln_head.launches = 0
    x = torch.randn((1, 32, 32, 16, 1), device=cuda_device)
    model(x).square().mean().backward()
    torch.cuda.synchronize()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    blocks = len(dims) + 1  # the stem and one block a stage
    assert dwconv3d_wgrad.launches == blocks and dwconv3d.launches == 2 * blocks - 1
    assert mlp_block_tail.launches == sum(d % 8 == 0 for d in dims)
    assert ln_head.launches == (dims[-1] % 8 == 0)
