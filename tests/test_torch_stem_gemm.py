"""The bf16 stem's tensor-core GEMMs at every width and kernel size
(``skoots_tpu_torch/csrc/dwconv.cu::stem_gemm_chunk_kernel`` and
``csrc/dwconv_wgrad.cu::stem_wgrad_chunk_kernel``), stated in torch and run
at f32 on the CPU against the plain versions; then the plain stem at k = 9,
C = 48 against JAX's.

The statements index as the kernels do:

- forward: the launcher's channel chunk (the widest class of 2, 4, 6 or 8
  n8 tiles whose panel, halo and output stage fit 227 KB of shared memory,
  then C split as evenly as 8-channel units allow; a chunk narrower than
  its class has zero weight columns); tiles of 16 z and 8 y rows, a warp
  each, at k >= 9, 16 y rows, two a warp, at k <= 7 (a B fragment feeds
  both rows' products); K = the k^2
  (dx, dy) groups of G dz lanes, G = 8 at k <= 7 (two groups a k-step,
  the padding group past k^2 reading group 0's rows against the zero row)
  and 16 at k >= 9; the panel holds the k^3 taps and one zero row, which
  every lane with dz >= k addresses; A is the Hankel window of the staged
  halo, whose columns past the 16 + k - 1 staged z are zero;
- weight gradient: chunks of at most 64 channels in the same classes;
  items (dx, dy pair) at k <= 7 (rows dz of dy and of dy + 1) or (dx, dy)
  at k >= 9 (rows the 16 dz), dealt to groups of 8 warps of at most
  16 / NT items each; for every (x, y) column and 16-z tile
  ``E[m, c] = sum_z A[m, z] g[z, c]``; rows whose dy or dz reach k are
  dropped, the rest are the taps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels import dwconv as D
from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref, dwconv3d_wgrad_ref

SMEM_OPTIN = 232448  # a block's shared memory on the H100 (csrc/common.cuh)
WARPS, ZT = 8, 16  # warps of a block; z of a tile (the mma's M or K)
ACC = 16  # items x n8 tiles of a wgrad warp's sums


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cdiv(a, b):
    return -(-a // b)


def row_stride(nt):
    """A panel, output-stage or cotangent row of an ``nt``-tile class: its
    columns and 8 more, an odd number of 16-byte units."""
    return 8 * nt + 8


def nt_class(units):
    """The n8-tile class (2, 4, 6 or 8) of a chunk of ``units`` x 8 channels."""
    return 2 if units <= 2 else cdiv(units, 2) * 2


# ------------------------------------------------------------------ forward

def fwd_geometry(k):
    """(G dz lanes a group, halo rows, halo row length, one halo copy,
    panel rows) of ``stem_gemm_chunk_kernel<k, NT>``."""
    g = 8 if k <= 7 else 16
    hy, hz = fwd_rows(k) + k - 1, 24 if g == 8 else 32
    return g, hy, hz, cdiv(k * hy * hz, 64) * 64 + 32, k ** 3 + 1


def fwd_rows(k):
    """y rows of a forward tile: two a warp at k <= 7, one at k >= 9."""
    return WARPS * (2 if k <= 7 else 1)


def fwd_smem(k, stride):
    _, _, _, copy, rows = fwd_geometry(k)
    return (rows * stride + 2 * copy + WARPS * ZT * stride) * 2


def stem_chunk(k, c):
    """The launcher's (chunk, NT class) at ``c`` channels and ``k``."""
    cmax = 8
    while cmax > 2 and fwd_smem(k, row_stride(cmax)) > SMEM_OPTIN:
        cmax -= 2
    units = c // 8
    n = cdiv(units, cmax)
    chunk = 8 * cdiv(units, n)
    return chunk, nt_class(chunk // 8)


def test_forward_chunks_fit_and_cover():
    """Every chunk's block fits shared memory, the classes are the widest
    that fit (64 channels to k = 9, 48 at 11, 32 at 13, 16 at 15), and the
    chunks of every C cover it once; the path's widths keep one chunk."""
    assert [stem_chunk(k, 256)[1] for k in (3, 7, 9, 11, 13, 15)] == [8, 8, 8, 6, 4, 2]
    assert stem_chunk(7, 48) == (48, 6) and stem_chunk(9, 16) == (16, 2)
    assert stem_chunk(7, 24) == (24, 4) and stem_chunk(7, 72) == (40, 6)
    for k in range(3, 16, 2):
        for c in range(8, 257, 8):
            chunk, nt = stem_chunk(k, c)
            assert chunk <= 8 * nt <= 64 and fwd_smem(k, row_stride(nt)) <= SMEM_OPTIN
            starts = range(0, c, chunk)
            assert sum(min(chunk, c - c0) for c0 in starts) == c
            assert all(min(chunk, c - c0) > 0 for c0 in starts)


def test_halo_pairs_are_aligned_and_inside():
    """Lane (g, q) reads 4-byte pairs at halo z g + 2q, + 8 (and + 16 at
    G = 16) from copy g & 1, shifted by one in copy 1: every pair starts on
    an even element, copy 1's writes stay in their row, and reads stay in
    the rows' length; both copies' pairs fall 16 banks apart."""
    lane = np.arange(32)
    g, q = lane // 4, lane % 4
    for k in range(3, 16, 2):
        gl, hy, hz, copy, _ = fwd_geometry(k)
        assert copy % 2 == 0 and (copy // 2) % 32 == 16
        assert ZT + k - 1 + 1 <= hz  # copy 1's last staged z stays in its row
        for extra in ((0, 8) if gl == 8 else (0, 8, 16)):
            start = (g & 1) * (copy + 1) + g + 2 * q + extra
            assert (start % 2 == 0).all()
            assert (g + 2 * q + extra + 1 + (g & 1) < hz).all()


def lane_rows(k, step):
    """The panel row (k^3: the zero row) each of the 16 K lanes of a k-step
    addresses, and the (dx, dy) group whose halo rows its A lanes read."""
    gl = 8 if k <= 7 else 16
    rows, groups = [], []
    for kk in range(16):
        grp, dz = step * (16 // gl) + kk // gl, kk % gl
        rows.append(grp * k + dz if dz < k and grp < k * k else k ** 3)
        groups.append(grp if grp < k * k else 0)
    return rows, groups


def stem_gemm_chunk_emulated(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``stem_gemm_chunk_kernel``'s products at f32: x ``[B, X, Y, Z, 1]``."""
    bsz, xs, ys, zs, _ = x.shape
    k, c = w.shape[0], w.shape[-1]
    p, gl = k // 2, 8 if k <= 7 else 16
    steps = cdiv(k * k, 16 // gl)
    yp, zp = cdiv(ys, fwd_rows(k)) * fwd_rows(k), cdiv(zs, ZT) * ZT
    # the halo as the tiles stage it: input zero-padded by k/2, z windows of
    # 16 lanes from every output z, zero past the 16 + k - 1 staged z
    xpad = torch.zeros(bsz, xs + 2 * p, yp + 2 * p, zp + 2 * p + 16)
    xpad[:, p:p + xs, p:p + ys, p:p + zs] = x[..., 0].float()
    win = xpad.unfold(-1, 16, 1)[..., :zp, :]  # [.., z, lane] = xpad[z + lane]
    staged = (torch.arange(zp)[:, None] % ZT + torch.arange(16)[None]) < ZT + k - 1
    win = win * staged
    out = torch.zeros(bsz, xs, yp, zp, c)
    chunk, nt = stem_chunk(k, c)
    for c0 in range(0, c, chunk):
        cn = min(chunk, c - c0)
        panel = torch.zeros(k ** 3 + 1, 8 * nt)  # the taps, then the zero row
        panel[:k ** 3, :cn] = w.float().reshape(k ** 3, c)[:, c0:c0 + cn]
        acc = torch.zeros(bsz, xs, yp, zp, 8 * nt)
        for s in range(steps):
            rows, groups = lane_rows(k, s)
            a = torch.stack([win[:, grp // k:grp // k + xs, grp % k:grp % k + yp, :, kk % gl]
                             for kk, grp in enumerate(groups)], -1)
            acc += a @ panel[rows]
        out[..., c0:c0 + cn] = acc[..., :cn]
    return (out + b.float())[:, :, :ys, :zs]


def _stem_inputs(rng, shape, c, k):
    x = rng.standard_normal((*shape, 1)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


WIDTHS = [8, 16, 48, 256]
KS = [3, 7, 9, 11, 15]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("c", WIDTHS)
def test_stem_gemm_chunk_matches_plain_version(rng, c, k):
    """X = 5, Y = 19 (a ragged second y tile), Z = 19 (a ragged z tile);
    batch 2 up to k = 9."""
    shape = (2 if k <= 9 else 1, 5, 19, 19)
    x, w, b = _stem_inputs(rng, shape, c, k)
    # f32 sums of the same k^3 products in another order
    torch.testing.assert_close(stem_gemm_chunk_emulated(x, w, b), dwconv3d_ref(x, w, b),
                               atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------- weight gradient

def wgrad_plan(k, c):
    """The plan's (chunk, NT class, paired, item groups, items a dx)."""
    units = c // 8
    n = cdiv(units, 8)
    chunk = 8 * cdiv(units, n)
    nt = nt_class(chunk // 8)
    paired = k <= 7
    per_dx = cdiv(k, 2) if paired else k
    ngr = cdiv(k * per_dx, WARPS * (ACC // nt))
    return chunk, nt, paired, ngr, per_dx


def warp_items(k, c):
    """{(group, warp): its items}, as the kernel deals them."""
    _, nt, _, ngr, per_dx = wgrad_plan(k, c)
    items = k * per_dx
    ipg = cdiv(items, ngr)
    ipw = cdiv(ipg, WARPS)
    assert ipw <= ACC // nt  # the warp's sums fit its registers
    dealt = {}
    for grp in range(ngr):
        i0, i1 = grp * ipg, min(items, grp * ipg + ipg)
        for warp in range(WARPS):
            my0 = i0 + warp * ipw
            dealt[grp, warp] = list(range(my0, my0 + max(0, min(ipw, i1 - my0))))
    return dealt


def test_wgrad_items_are_dealt_once():
    """Every item of every (k, C) goes to exactly one warp of one group, no
    warp holding more than its registers take."""
    for k in range(3, 16, 2):
        for c in range(8, 257, 8):
            per_dx = cdiv(k, 2) if k <= 7 else k
            got = sorted(i for items in warp_items(k, c).values() for i in items)
            assert got == list(range(k * per_dx)), (k, c)


def stem_wgrad_chunk_emulated(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """``stem_wgrad_chunk_kernel``'s products at f32: x ``[B, X, Y, Z, 1]``,
    g ``[B, X, Y, Z, C]``; every warp's items over every (x, y) column and
    16-z tile, in the kernel's (group, warp, item) order."""
    bsz, xs, ys, zs, c = g.shape
    p = k // 2
    zp = cdiv(zs, ZT) * ZT
    chunk, nt, paired, _, per_dx = wgrad_plan(k, c)
    # the staged halo of every column: zero outside the volume and past the
    # 16 + k - 1 staged z; one zero row past the last dy (a pair's second
    # dy past k reads a row it drops)
    xpad = torch.zeros(bsz, xs + 2 * p, ys + 2 * p + 1, zp + 2 * p + 16)
    xpad[:, p:p + xs, p:p + ys, p:p + zs] = x[..., 0].float()
    win = xpad.unfold(-1, ZT, 1)  # [.., z start, z]
    m = torch.arange(16)
    dw = torch.zeros(k, k, k, c)
    for c0 in range(0, c, chunk):
        cn = min(chunk, c - c0)
        gt = torch.zeros(bsz, xs, ys, zp, 8 * nt)  # the cotangent, zero past Z and cn
        gt[:, :, :, :zs, :cn] = g[..., c0:c0 + cn].float()
        gt = gt.reshape(bsz, xs, ys, zp // ZT, ZT, 8 * nt)
        for items in warp_items(k, c).values():
            for it in items:
                dx, r = divmod(it, per_dx)
                dy = 2 * r + m // 8 if paired else torch.full((16,), r)
                dz = m % 8 if paired else m
                # A[m, tile, b, x, y, z] = xpad[b, x + dx, y + dy(m), z0 + z + dz(m)]
                rows = win[:, dx:dx + xs][:, :, dy[:, None] + torch.arange(ys)[None]]
                rows = rows.permute(2, 4, 0, 1, 3, 5)  # [m, z start, b, x, y, z]
                starts = torch.arange(0, zp, ZT)[None] + dz[:, None]  # [m, tile]
                a = rows[m[:, None], starts]
                staged = (torch.arange(ZT)[None] + dz[:, None]) < ZT + k - 1  # [m, z]
                a = a * staged[:, None, None, None, None, :]
                e = torch.einsum("mtbxyz,bxytzc->mc", a, gt)
                keep = (dy < k) & (dz < k)
                dw[dx, dy[keep], dz[keep], c0:c0 + cn] = e[keep][:, :cn]
    return dw


def _wgrad_operands(rng, shape, c):
    x = torch.from_numpy(rng.standard_normal((*shape, 1)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((*shape, c)).astype(np.float32))
    return x, g


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("c", WIDTHS)
def test_stem_wgrad_chunk_matches_plain_version(rng, c, k):
    """X = 3, Y = 18 and Z = 20 (ragged 16 x 16 tiles); batch 2 up to k = 9."""
    x, g = _wgrad_operands(rng, (2 if k <= 9 else 1, 3, 18, 20), c)
    want = dwconv3d_wgrad_ref(x, g, k)
    # f32 sums of the same products in another order
    torch.testing.assert_close(stem_wgrad_chunk_emulated(x, g, k), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# ------------------------------------------------------------------- JAX

def test_plain_stem_matches_jax_at_k9_c48(rng, monkeypatch):
    """k = 9, 1 -> 48: the plain stem against JAX's (the depthwise conv on
    the input broadcast to 48 channels, ``_xla_dwconv_ref`` as the JAX
    package's tests run it on the CPU), and the weight and input gradients
    of the port's autograd wrapper against the JAX ``custom_vjp`` backward
    (its XLA form: the Pallas input gradient has no CPU path at this k);
    f32 sums of 729 products in another order, 1e-4."""
    monkeypatch.setenv("SKOOTS_DGRAD_IMPL", "xla")
    k, c = 9, 48
    x = rng.standard_normal((1, 10, 9, 12, 1)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    g = rng.standard_normal((1, 10, 9, 12, c)).astype(np.float32)
    wide = np.broadcast_to(x, g.shape).copy()
    want = np.asarray(D._xla_dwconv_ref(jnp.asarray(wide), jnp.asarray(w), jnp.asarray(b)))
    T = torch.from_numpy
    np.testing.assert_allclose(dwconv3d_ref(T(x), T(w), T(b)).numpy(), want, atol=1e-4, rtol=1e-4)
    jdx, jdw, jdb = D._dwconv3d_bwd((jnp.asarray(wide), jnp.asarray(w), jnp.asarray(b)),
                                    jnp.asarray(g))
    np.testing.assert_allclose(dwconv3d_wgrad_ref(T(x), T(g), k).numpy(), np.asarray(jdw),
                               atol=1e-4, rtol=1e-4)
    xt, wt, bt = (T(a).requires_grad_() for a in (x, w, b))
    dwconv3d(xt, wt, bt).backward(T(g))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx).sum(-1, keepdims=True),
                               atol=1e-4, rtol=1e-4)
