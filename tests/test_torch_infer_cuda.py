"""The host-streaming slice's CUDA kernels on the card: the propagate
kernel bit for bit against its plain passes, and the stepped CC's launches
following ``launch_plan`` (the plain propagation never runs on a CUDA
tensor), the upsample kernel bit for bit against its plain version with
its autograd gradient, the two microbenchmarks against theirs, and the
depthwise conv, the block tail and the LN head (bf16 on the tensor cores,
f32 on the FP32 pipe) at ragged shapes against theirs.

Imports no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_infer_cuda.py -m cuda

Every test needs a GPU and skips elsewhere.
"""

import numpy as np
import pytest
import torch
from propagate_cases import PASSES, corner_tube_case, plain

from skoots_tpu_torch.kernels import propagate as prop_mod
from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref, dwconv3d_route
from skoots_tpu_torch.kernels.lnhead import ln_head, ln_head_ref
from skoots_tpu_torch.kernels.microbench import (
    SHAPE,
    fma_chain,
    fma_chain_ref,
    loadfma,
    loadfma_ref,
)
from skoots_tpu_torch.kernels.mlp import mlp_block_tail, mlp_block_tail_ref
from skoots_tpu_torch.kernels.upsample import upsample2x, upsample2x_ref
from skoots_tpu_torch.ops.flood_fill import label_components, make_label_components_stepped
from skoots_tpu_torch.tools.bench_propagate import default_tile


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _no_plain_propagation(*args, **kwargs):
    raise AssertionError("the plain propagation ran on the card")


@pytest.mark.cuda
def test_cuda_propagate_matches_plain_passes(cuda_device):
    """The kernel against ``propagate_ref`` applied ``passes`` times, bit
    for bit: both connectivities, passes below, at and past QMAX and not a
    multiple of it, the CPU tests' ragged volumes (empty tiles, labels at
    the background, a tube through the tiles' corners, axis lines), and a
    sparse volume of more tiles than the persistent grid's blocks with a
    bool mask; ``len(launch_plan(passes))`` launches a call."""
    tile = default_tile()
    cases = [corner_tube_case(shape, tile, sum(shape), background)
             for shape, background in (((37, 21, 53), False), ((19, 30, 70), True),
                                       ((40, 21, 53), True), ((1, 1, 1), False))]
    rng = np.random.default_rng(5)
    fg = rng.random((150, 90, 101)) < 0.05
    lab = np.where(fg, rng.integers(1, 2**31 - 1, fg.shape), rng.integers(0, 9, fg.shape))
    cases.append((torch.from_numpy(lab.astype(np.int32)), torch.from_numpy(fg)))
    prop_mod.propagate.launches = 0
    launches = 0
    for lab, fg in cases:
        for conn in (26, 6):
            for passes in PASSES:
                got = prop_mod.propagate(lab.to(cuda_device), fg.to(cuda_device), passes, conn)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), plain(lab, fg, passes, conn)), (lab.shape, passes)
                launches += len(prop_mod.launch_plan(passes))
    assert prop_mod.propagate.launches == launches


@pytest.mark.cuda
def test_cuda_cc_launches_follow_the_launch_plan(cuda_device, monkeypatch):
    """6 and 3 propagation passes per round (6 not a multiple of QMAX):
    ``len(launch_plan(passes))`` launches a round, the labels those of the
    plain passes on the CPU."""
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
    assert prop_mod.propagate.launches == want.last_rounds * len(prop_mod.launch_plan(6))
    prop_mod.propagate.launches = 0
    lab, converged = label_components(torch.from_numpy(mask).to(cuda_device),
                                      propagates_per_round=3, jumps_per_round=2,
                                      return_converged=True)
    torch.cuda.synchronize()
    assert converged and prop_mod.propagate.launches > 0
    assert prop_mod.propagate.launches == (label_components.last_rounds
                                           * len(prop_mod.launch_plan(3)))


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


def _bf16_ulps(got, ref):
    """max |got - ref| in bf16 ulps of max(|ref|, rms(ref)): both round one
    f32 sum once, in another summation order."""
    r = ref.float().abs()
    scale = torch.maximum(r, r.square().mean().sqrt())
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


@pytest.mark.cuda
def test_cuda_dwconv_matches_plain_version_at_ragged_shapes(cuda_device):
    """bf16 (tensor cores) within 1 bf16 ulp, f32 within 1e-5 of max|plain|:
    k = 3, 5, 7, the stem (32 channels: the implicit GEMM; 64: the banded
    kernel), batch 2, X, Y and Z that no tile divides; and
    the bf16 input gradient (the kernel on the cotangent with flipped taps)
    against its plain composition."""
    rng = np.random.default_rng(3)
    dwconv3d.launches = 0
    cases = [((2, 9, 18, 20), 32, 32, 7), ((1, 13, 20, 5), 1, 32, 7),
             ((2, 5, 9, 21), 1, 32, 5), ((1, 9, 18, 10), 1, 64, 7),
             ((2, 7, 17, 10), 64, 64, 5), ((1, 11, 33, 24), 128, 128, 3),
             ((1, 24, 24, 8), 128, 128, 7)]
    for shape, cin, c, k in cases:
        x32 = torch.from_numpy(rng.standard_normal((*shape, cin)).astype(np.float32))
        w32 = torch.from_numpy((rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32))
        b32 = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(cuda_device, dt)
            w, b = w32.to(cuda_device).to(dt).float(), b32.to(cuda_device).to(dt).float()
            got, ref = dwconv3d(x, w, b), dwconv3d_ref(x, w, b)
            assert got.dtype == dt and got.shape == ref.shape
            if dt == torch.bfloat16:
                assert _bf16_ulps(got, ref) <= 1.0, (shape, cin, k)
            else:
                err = float((got - ref).abs().max()) / float(ref.abs().max())
                assert err <= 1e-5, (shape, cin, k, err)
    x = torch.from_numpy(rng.standard_normal((2, 9, 18, 20, 32)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16).requires_grad_()
    w = torch.randn((7, 7, 7, 32), device=cuda_device).div(18.5).to(torch.bfloat16).float()
    b = torch.zeros(32, device=cuda_device)
    g = torch.randn(x.shape, device=cuda_device).to(torch.bfloat16)
    (dx,) = torch.autograd.grad(dwconv3d(x, w, b), x, g)
    want = dwconv3d_ref(g, torch.flip(w, (0, 1, 2)), b)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and _bf16_ulps(dx, want) <= 1.0
    assert dwconv3d.launches == 2 * len(cases) + 2
    stems = [(c, k) for c in (16, 48, 256) for k in (3, 7, 9, 11)]
    for c, k in stems:
        route = dwconv3d_route(torch.bfloat16, 0, c, k)
        assert route.startswith(f"stem_gemm_chunk_kernel<{k},"), (c, k, route)
        assert not dwconv3d_route(torch.float32, 0, c, k).startswith("stem_"), (c, k)
        x = torch.from_numpy(rng.standard_normal((2, 9, 14, 11, 1)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
        x = x.to(cuda_device, torch.bfloat16)
        w = w.to(cuda_device).to(torch.bfloat16).float()
        b = b.to(cuda_device).to(torch.bfloat16).float()
        got, ref = dwconv3d(x, w, b), dwconv3d_ref(x, w, b)
        assert got.dtype == torch.bfloat16 and _bf16_ulps(got, ref) <= 1.0, (c, k, route)
    assert dwconv3d.launches == 2 * len(cases) + 2 + len(stems)


@pytest.mark.cuda
def test_cuda_block_tail_matches_plain_version_at_ragged_shapes(cuda_device):
    """bf16 (tensor cores) and f32 at the Pallas test's bound, at V that no
    row tile divides (one row; a tile and a few rows; a large ragged V)."""
    rng = np.random.default_rng(4)
    mlp_block_tail.launches = 0
    cases = [(100003, 32), (12347, 64), (3001, 128), (1, 32), (130, 128)]
    for v, c in cases:
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        args = [f(v, c), f(v, c) * 0.1, f(c) * 0.1 + 1.0, f(c) * 0.1,
                f(c, 4 * c) / c ** 0.5, f(4 * c) * 0.1, f(4 * c, c) / (2 * c ** 0.5),
                f(c) * 0.1, torch.full((c,), 0.5)]
        for dt in (torch.bfloat16, torch.float32):
            a = [t.to(cuda_device) for t in args]
            for i in (0, 1, 4, 6):
                a[i] = a[i].to(dt)
            # x three elements into its buffer: rows off a 16-byte boundary
            x = torch.empty(v * c + 3, dtype=dt, device=cuda_device)[3:].view(v, c)
            a[0] = x.copy_(a[0])
            got, ref = mlp_block_tail(*a), mlp_block_tail_ref(*a)
            assert got.dtype == dt and got.shape == ref.shape
            torch.testing.assert_close(got.float(), ref.float(), atol=4e-3, rtol=1e-3)
    torch.cuda.synchronize()
    assert mlp_block_tail.launches == 2 * len(cases)


@pytest.mark.cuda
def test_cuda_ln_head_matches_plain_version_at_ragged_shapes(cuda_device):
    """Equal to the plain version at bf16 (tensor cores; the sums whose
    rounding their order could change recomputed in the plain order) and at
    f32 (FP32 pipe, the plain order): at V that no 32-row warp tile divides
    (one row; a large ragged V), N = 8 and 5 (a partial n8 tile), C = 64
    and C = 128 (W read from shared memory), N = 128."""
    rng = np.random.default_rng(6)
    ln_head.launches = 0
    cases = [(100003, 32, 32), (1, 32, 32), (12347, 32, 8), (4173, 64, 32),
             (3001, 128, 5), (130, 128, 128)]
    for v, c, n in cases:
        f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
        args = [f(v, c), f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, n) / c ** 0.5, f(n) * 0.1]
        for dt in (torch.bfloat16, torch.float32):
            a = [t.to(cuda_device) for t in args]
            a[0], a[3] = a[0].to(dt), a[3].to(dt)
            got, ref = ln_head(*a), ln_head_ref(*a)
            assert got.dtype == dt and got.shape == ref.shape
            assert torch.equal(got, ref), (v, c, n, dt, _bf16_ulps(got, ref))
    torch.cuda.synchronize()
    assert ln_head.launches == 2 * len(cases)


def _tail_exact(x, sc, ls, lb, w1, b1, w2, b2, g):
    """``mlp_block_tail_ref`` with each matmul's products summed in f64 and
    rounded once to f32: the value every f32 summation order approximates,
    whatever the order of the card's BLAS."""
    from skoots_tpu_torch.kernels.mlp import _rnd, layer_norm_rows

    dt = x.dtype
    h = layer_norm_rows(x, ls, lb, dt)
    a = _rnd((h.double() @ _rnd(w1.float(), dt).double()).float(), dt)
    a = _rnd(a + _rnd(b1.float(), dt), dt)
    a = _rnd(0.5 * a * (1.0 + torch.erf(a * (1.0 / np.sqrt(2.0)))), dt)
    y = _rnd((a.double() @ _rnd(w2.float(), dt).double()).float(), dt)
    y = _rnd(_rnd(y + _rnd(b2.float(), dt), dt) * _rnd(g.float(), dt), dt)
    return (sc.float() + y).to(dt)


@pytest.mark.cuda
def test_cuda_tail_and_ln_head_at_every_width(cuda_device):
    """Every width JAX's kernels take, C = 8, 16, ..., 256, bf16 and f32,
    at a V no tile divides, on rows that start off a 16-byte boundary; the
    LN head at N = C and also at N = 200, 256, 5 and 130 (64-column chunks,
    a partial n8 tile) for a spread of widths. The route query names one of
    the package's kernels for every launch (the templates at C = 16, 32,
    64, 128; the width classes and the staged tail elsewhere; the f32
    kernels).
    The tail at f32 within the Pallas test's bound; at bf16 within 2 bf16
    ulps of max(|plain|, rms(plain)): the tail rounds at five points, and a
    sum in another order can flip the rounding of y = gamma * pw2(...) and
    then of shortcut + y, two ulps where |y| is as large as the output
    (gamma 0.5 here). A failure reports both versions' distance from the
    plain version with its sums taken in f64 and rounded once
    (``_tail_exact``), the value every f32 order approximates. The LN head
    equal."""
    from skoots_tpu_torch.kernels.lnhead import HEAD_KERNELS, ln_head_route
    from skoots_tpu_torch.kernels.mlp import TAIL_KERNELS, mlp_tail_route

    rng = np.random.default_rng(8)
    mlp_block_tail.launches = ln_head.launches = 0
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    widths = range(8, 257, 8)
    for c in widths:
        v = 4099
        args = [f(v, c), f(v, c) * 0.1, f(c) * 0.1 + 1.0, f(c) * 0.1,
                f(c, 4 * c) / c ** 0.5, f(4 * c) * 0.1, f(4 * c, c) / (2 * c ** 0.5),
                f(c) * 0.1, torch.full((c,), 0.5)]
        for dt in (torch.bfloat16, torch.float32):
            assert mlp_tail_route(dt, c).startswith(TAIL_KERNELS), (c, dt)
            a = [t.to(cuda_device) for t in args]
            for i in (0, 1, 4, 6):
                a[i] = a[i].to(dt)
            # x three elements into its buffer: rows off a 16-byte boundary
            x = torch.empty(v * c + 3, dtype=dt, device=cuda_device)[3:].view(v, c)
            a[0] = x.copy_(a[0])
            got, ref = mlp_block_tail(*a), mlp_block_tail_ref(*a)
            assert got.dtype == dt and got.shape == ref.shape
            if dt == torch.bfloat16:
                assert _bf16_ulps(got, ref) <= 2.0, (
                    c, _bf16_ulps(got, ref), "from the exact sums: kernel",
                    _bf16_ulps(got, _tail_exact(*a)), "plain", _bf16_ulps(ref, _tail_exact(*a)))
            else:
                torch.testing.assert_close(got, ref, atol=4e-3, rtol=1e-3)
    head_cases = [(c, c) for c in widths] + [
        (c, n) for c in (8, 16, 24, 32, 48, 96, 192, 256) for n in (200, 256, 5, 130)]
    for c, n in head_cases:
        args = [f(4099, c), f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, n) / c ** 0.5, f(n) * 0.1]
        for dt in (torch.bfloat16, torch.float32):
            assert ln_head_route(dt, c, n).startswith(HEAD_KERNELS), (c, n, dt)
            a = [t.to(cuda_device) for t in args]
            # x three elements into its buffer: rows off a 16-byte boundary
            x = torch.empty(4099 * c + 3, dtype=dt, device=cuda_device)[3:].view(4099, c)
            a[0], a[3] = x.copy_(a[0]), a[3].to(dt)
            got, ref = ln_head(*a), ln_head_ref(*a)
            assert got.dtype == dt and got.shape == ref.shape
            assert torch.equal(got, ref), (c, n, dt, _bf16_ulps(got, ref))
    torch.cuda.synchronize()
    assert mlp_block_tail.launches == 2 * len(widths)
    assert ln_head.launches == 2 * len(head_cases)
    assert mlp_tail_route(torch.bfloat16, 12) is None
    assert ln_head_route(torch.bfloat16, 264, 8) is None


@pytest.mark.cuda
def test_cuda_dwconv_at_every_odd_k(cuda_device):
    """k = 9 and 11: bf16 within 1 bf16 ulp, f32 within 1e-5 of max|plain|,
    the depthwise layer and the stem, batch 2 on ragged X, Y, Z; the bf16
    input gradient against its plain composition; then the bf16 stems at C
    = 16, 48, 256 and k = 3, 7, 9, 11, each on the stem GEMM its route names
    (``stem_gemm_chunk_kernel<k, NT>``), within 1 bf16 ulp; then bf16
    depthwise layers at k = 9 to 15 and C = 16, 32, 48, 96, 256 on
    ``dwconv3d_big_kernel<k>``, and those it does not take (C off 8 at k =
    9 and 11, k = 17) on ``dwconv3d_any_kernel<bf16>``, within 1 bf16 ulp."""
    rng = np.random.default_rng(9)
    dwconv3d.launches = 0
    cases = [((2, 9, 14, 11), 16, 16, 9), ((1, 12, 10, 13), 1, 16, 11),
             ((1, 8, 9, 10), 64, 64, 9)]
    for shape, cin, c, k in cases:
        x32 = torch.from_numpy(rng.standard_normal((*shape, cin)).astype(np.float32))
        w32 = torch.from_numpy((rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32))
        b32 = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(cuda_device, dt)
            w, b = w32.to(cuda_device).to(dt).float(), b32.to(cuda_device).to(dt).float()
            got, ref = dwconv3d(x, w, b), dwconv3d_ref(x, w, b)
            assert got.dtype == dt and got.shape == ref.shape
            if dt == torch.bfloat16:
                assert _bf16_ulps(got, ref) <= 1.0, (shape, cin, k)
            else:
                err = float((got - ref).abs().max()) / float(ref.abs().max())
                assert err <= 1e-5, (shape, cin, k, err)
    x = torch.from_numpy(rng.standard_normal((2, 9, 14, 11, 16)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16).requires_grad_()
    w = torch.randn((9, 9, 9, 16), device=cuda_device).div(27.0).to(torch.bfloat16).float()
    b = torch.zeros(16, device=cuda_device)
    g = torch.randn(x.shape, device=cuda_device).to(torch.bfloat16)
    (dx,) = torch.autograd.grad(dwconv3d(x, w, b), x, g)
    want = dwconv3d_ref(g, torch.flip(w, (0, 1, 2)), b)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and _bf16_ulps(dx, want) <= 1.0
    assert dwconv3d.launches == 2 * len(cases) + 2
    stems = [(c, k) for c in (16, 48, 256) for k in (3, 7, 9, 11)]
    for c, k in stems:
        route = dwconv3d_route(torch.bfloat16, 0, c, k)
        assert route.startswith(f"stem_gemm_chunk_kernel<{k},"), (c, k, route)
        assert not dwconv3d_route(torch.float32, 0, c, k).startswith("stem_"), (c, k)
        x = torch.from_numpy(rng.standard_normal((2, 9, 14, 11, 1)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
        x = x.to(cuda_device, torch.bfloat16)
        w = w.to(cuda_device).to(torch.bfloat16).float()
        b = b.to(cuda_device).to(torch.bfloat16).float()
        got, ref = dwconv3d(x, w, b), dwconv3d_ref(x, w, b)
        assert got.dtype == torch.bfloat16 and _bf16_ulps(got, ref) <= 1.0, (c, k, route)
    assert dwconv3d.launches == 2 * len(cases) + 2 + len(stems)
    # bf16 depthwise layers at k = 9 to 15: dwconv3d_big_kernel<k> at every
    # width (one operand contiguous but off a 16-byte boundary: the wrapper
    # aligns it); f32 still on the run-time-k kernel
    bigs = [(c, k) for k in (9, 11, 13, 15) for c in (16, 32, 48, 96, 256)]
    for c, k in bigs:
        assert dwconv3d_route(torch.bfloat16, 1, c, k) == f"dwconv3d_big_kernel<{k}>", (c, k)
        assert dwconv3d_route(torch.float32, 1, c, k) == "dwconv3d_any_kernel<float>", (c, k)
        shape = (2, 11, 37, 13, c) if c <= 48 else (1, 9, 21, 11, c)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        if c == 48:
            flat = torch.empty(x.numel() + 1, device=cuda_device, dtype=torch.bfloat16)
            x = flat[1:].view(shape).copy_(x)
        else:
            x = x.to(cuda_device, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
        w = w.to(cuda_device).to(torch.bfloat16).float()
        b = b.to(cuda_device).to(torch.bfloat16).float()
        got, ref = dwconv3d(x, w, b), dwconv3d_ref(x, w, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and _bf16_ulps(got, ref) <= 1.0, (c, k)
    # the bf16 depthwise layers left to the run-time-k kernel
    anys = [(12, 9), (20, 11), (16, 17)]
    for c, k in anys:
        assert dwconv3d_route(torch.bfloat16, 1, c, k) == "dwconv3d_any_kernel<bf16>", (c, k)
        x = torch.from_numpy(rng.standard_normal((2, 11, 17, 13, c)).astype(np.float32))
        x = x.to(cuda_device, torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal(c) * 0.1).astype(np.float32))
        w = w.to(cuda_device).to(torch.bfloat16).float()
        b = b.to(cuda_device).to(torch.bfloat16).float()
        got, ref = dwconv3d(x, w, b), dwconv3d_ref(x, w, b)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and _bf16_ulps(got, ref) <= 1.0, (c, k)
    assert dwconv3d.launches == 2 * len(cases) + 2 + len(stems) + len(bigs) + len(anys)


@pytest.mark.cuda
def test_cuda_kernels_on_a_card_that_is_not_current(cuda_device):
    """Every kernel with its operands on ``cuda:1`` while ``cuda:0`` is the
    current card (the wrappers make the operands' card current for the
    launch, so the library's per-device set-up is that card's): each equal
    to its plain version as on one card, and ``cuda:0`` still current
    after. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad, dwconv3d_wgrad_ref

    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 12, 20, 16, 32), device=dev, generator=gen).to(torch.bfloat16)
    w = (torch.randn((7, 7, 7, 32), device=dev, generator=gen) / 18.5).to(torch.bfloat16).float()
    b = torch.zeros(32, device=dev)
    assert _bf16_ulps(dwconv3d(x, w, b), dwconv3d_ref(x, w, b)) <= 1.0
    g = torch.randn(x.shape, device=dev, generator=gen).to(torch.bfloat16)
    wg, wref = dwconv3d_wgrad(x, g, 7), dwconv3d_wgrad_ref(x, g, 7)
    assert float((wg - wref).abs().max()) <= 1e-2 * float(wref.abs().max())
    c = 32
    ln = (torch.ones(c, device=dev), torch.zeros(c, device=dev))
    w1 = torch.randn((c, 4 * c), device=dev, generator=gen) / c ** 0.5
    w2 = torch.randn((4 * c, c), device=dev, generator=gen) / (4 * c) ** 0.5
    args = (x, x, *ln, w1, torch.zeros(4 * c, device=dev), w2, torch.zeros(c, device=dev),
            torch.ones(c, device=dev))
    assert _bf16_ulps(mlp_block_tail(*args), mlp_block_tail_ref(*args)) <= 2.0
    wh = torch.randn((c, 5), device=dev, generator=gen) / c ** 0.5
    head = (x, *ln, wh, torch.zeros(5, device=dev))
    assert torch.equal(ln_head(*head), ln_head_ref(*head))
    assert torch.equal(upsample2x(x), upsample2x_ref(x))
    lab = torch.zeros((20, 30, 40), dtype=torch.int32, device=dev)
    fg = torch.zeros_like(lab, dtype=torch.uint8)
    fg[2:18, 5, 7:30] = 1
    lab[fg > 0] = torch.arange(1, int(fg.sum()) + 1, dtype=torch.int32, device=dev)
    assert torch.equal(prop_mod.propagate(lab, fg, passes=5), plain(lab, fg, 5, 26))
    masks = torch.zeros((16, 24, 8), dtype=torch.int32, device=dev)
    masks[2:12, 4:20, 2:6] = 1
    pts = torch.tensor([[5.0, 6.0, 3.0], [9.0, 15.0, 4.0]], device=dev)
    ids = torch.ones(2, dtype=torch.int32, device=dev)
    for got, ref in zip(bake_skeleton_kernel(masks, pts, ids), bake_skeleton_ref(masks, pts, ids)):
        assert torch.equal(got, ref)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
