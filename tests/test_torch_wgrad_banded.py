"""The bf16 depthwise weight gradient's tensor-core decomposition
(``skoots_tpu_torch/csrc/dwconv_wgrad.cu``), stated in torch and run at f32
on the CPU against the plain version (and, at one tiny shape, against the
TPU's ``dwconv3d_wgrad_pallas_v2`` in interpret mode); then the 32-channel
stem's Hankel implicit GEMM the same way.

The depthwise kernel (``dwconv3d_wgrad_tc_kernel``) indexes as follows:

- a unit is (batch, a range of ``xt`` cotangent x planes, 16 y rows, 8 z)
  of one 8-channel group; the launcher picks ``xt`` and the blocks a group
  (``tc_plan``), and block ``s`` walks units ``s, s + nper, ...``;
- the unit streams input planes ``xi = xs - k/2 + t`` for
  ``t < ng + k - 1``; its staged input window has rows ``y0 - k/2 + r``
  (``r < 16 + k - 1``) and 16 columns ``z0 - k/2 + i``, zero outside the
  volume; its cotangent plane ``xs + t`` has rows ``y0 + y`` and columns
  ``z0 + j`` (``j < 8``), zero outside the volume or past the range;
- step ``t`` puts the cotangent plane ``xs + t`` in ring slot ``t % k`` and,
  for each (dx, dy), adds ``E[i][j] += sum_y A[dy + y][i] * G_{t - dx}[y][j]``
  (one ``m16n8k16``: M = 16 window z, N = 8 z, K = 16 y rows) where
  ``0 <= t - dx < ng``;
- after every unit, ``dw[dx, dy, dz] = sum_j E[j + dz][j]``: the fragment
  through shared memory, lane dz adding its diagonal.

The stem (``stem_wgrad_tc_kernel``): for each (x, y) column, each dx (a
warp) and each pair of dy (2p, 2p + 1), ``E[m][c] += sum_z A[m][z] g[z, c]``
with ``A[m][z] = xpad[x + dx, y + 2p + m // 8, z0 + z + m % 8]`` (a Hankel
window; rows m % 8 >= k unused), M = 16, N = 32 channels, K = 16 z.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.dwconv import dwconv3d_wgrad_pallas_v2
from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad_ref

H100_SMS = 132
YT, ZT, ZW = 16, 8, 16  # unit rows (mma K), cotangent z (N), input window (M)
WARPS = 8  # channels of a block
SW_ZT, SW_YT = 16, 16  # the stem: z of a column (K), columns of a tile


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


# ------------------------------------------------------------------ fragments

def fragment_rc():
    """(row, col) of each lane's four A registers' low halves, per the
    m16n8k16 layout (g = lane / 4, q = lane % 4): a0 (g, 2q), a1 (g + 8, 2q),
    a2 (g, 2q + 8), a3 (g + 8, 2q + 8); the high half is the next column."""
    lane = torch.arange(32)
    g, q = lane // 4, lane % 4
    rows = torch.stack([g, g + 8, g, g + 8], 1)
    cols = torch.stack([2 * q, 2 * q, 2 * q + 8, 2 * q + 8], 1)
    return rows, cols


def ldmatrix_trans(mem: torch.Tensor, row_of_lane, col_of_lane, n: int) -> torch.Tensor:
    """``ldmatrix.x{n}.trans``: lane l gives the address of row l % 8 of
    matrix l / 8 (8 elements from ``mem[row, col:col + 8]``); thread t
    receives, from each matrix M, ``M[2(t % 4)][t / 4]`` and
    ``M[2(t % 4) + 1][t / 4]``. Returns ``[32 lanes, n, 2]``."""
    t = torch.arange(32)
    out = torch.empty(32, n, 2, dtype=mem.dtype)
    for i in range(n):
        for h in range(2):
            src = 8 * i + 2 * (t % 4) + h  # the lane whose row address is read
            out[:, i, h] = mem[row_of_lane[src], col_of_lane[src] + t // 4]
    return out


def mma_16816(a_regs: torch.Tensor, b_regs: torch.Tensor) -> torch.Tensor:
    """``mma.m16n8k16`` from per-lane fragments: A ``[32, 4, 2]`` (layout of
    :func:`fragment_rc`), B ``[32, 2, 2]`` (b0 = k 2q, 2q + 1 of column g;
    b1 = k 2q + 8, 2q + 9); returns D ``[16, 8]``."""
    a = torch.zeros(16, 16, dtype=a_regs.dtype)
    rows, cols = fragment_rc()
    for r in range(4):
        for h in range(2):
            a[rows[:, r], cols[:, r] + h] = a_regs[:, r, h]
    b = torch.zeros(16, 8, dtype=b_regs.dtype)
    lane = torch.arange(32)
    for r in range(2):
        for h in range(2):
            b[2 * (lane % 4) + 8 * r + h, lane // 4] = b_regs[:, r, h]
    return a @ b


def test_ldmatrix_trans_gives_the_transposed_band():
    """The kernel's lane addresses: A^T from the staged window (row
    ``(l & 7) + 8 (l >> 4)``, column ``8 ((l >> 3) & 1)``, rows ``dy``
    further down) and G from the staged cotangent (row ``l & 15``) make one
    m16n8k16 product equal ``A[dy:dy + 16]^T @ G``."""
    gen = torch.Generator().manual_seed(0)
    for k in (3, 7):
        plane = torch.randn(YT + k - 1, 24, generator=gen, dtype=torch.float64)
        gpl = torch.randn(YT, ZT, generator=gen, dtype=torch.float64)
        lane = torch.arange(32)
        for dy in range(k):
            a = ldmatrix_trans(plane, (lane & 7) + ((lane >> 4) << 3) + dy,
                               ((lane >> 3) & 1) * 8, 4)
            b = ldmatrix_trans(gpl, lane & 15, torch.zeros(32, dtype=torch.long), 2)
            want = plane[dy:dy + YT, :ZW].T @ gpl
            torch.testing.assert_close(mma_16816(a, b), want, rtol=0, atol=1e-12)


def diagonal_epilogue(e: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's epilogue for one E ``[16, 8]``: each lane stores its
    four fragment values into a 16 x 8 scratch, then lane dz < k adds
    ``scratch[j + dz][j]`` for j = 0, 1, ... in order."""
    rows, cols = fragment_rc()
    scratch = torch.zeros(16, 8, dtype=e.dtype)
    for r in (0, 1):  # d0, d1: (g, 2q), (g, 2q + 1); d2, d3: (g + 8, ...)
        for h in range(2):
            scratch[rows[:, r], cols[:, 0] + h] = e[rows[:, r], cols[:, 0] + h]
    out = torch.zeros(k, dtype=e.dtype)
    for dz in range(k):
        for j in range(ZT):
            out[dz] += scratch[j + dz, j]
    return out


@pytest.mark.parametrize("k", [3, 7])
def test_diagonal_epilogue_is_the_dz_taps(k):
    """``sum_j E[j + dz][j]`` over the stored fragments is each tap's sum of
    products ``x[z0 - k/2 + j + dz] * g[z0 + j]``."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(YT, ZW, generator=gen, dtype=torch.float64)  # window z0 - k/2 + i
    gz = torch.randn(YT, ZT, generator=gen, dtype=torch.float64)  # cotangent z0 + j
    want = torch.stack([(a[:, dz:dz + ZT] * gz).sum() for dz in range(k)])
    torch.testing.assert_close(diagonal_epilogue(a.T @ gz, k), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- the plan

def tc_plan(bsz, xs, ys, zs, c, k, sms=H100_SMS, per_sm=1):
    """The launcher's (nxs, xt, units, nper): blocks a channel group = one
    wave of the card, then the x range whose units, dealt round-robin,
    finish soonest (a unit of xt planes costs xt + k - 1 + 2)."""
    target = max(1, sms * per_sm // (c // WARPS))
    cols = bsz * cdiv(ys, YT) * cdiv(zs, ZT)
    best = None
    for nxs in range(1, xs + 1):
        xt = cdiv(xs, nxs)
        if cdiv(xs, xt) != nxs:
            continue
        units = cols * nxs
        per_block = cdiv(units, target)
        cost = per_block * (xt + k - 1 + 2)
        if best is None or cost < best[0]:
            best = (cost, nxs, xt, units, cdiv(units, per_block))
    return best[1:]


def unit_of(u, nxs, nyb, nzb):
    """(batch, x range, y block, z block) of unit u, z fastest."""
    zb, u = u % nzb, u // nzb
    yb, u = u % nyb, u // nyb
    return u // nxs, u % nxs, yb, zb


TRAIN_SHAPES = [((1, 96, 96, 32), 32), ((1, 48, 48, 16), 64), ((1, 24, 24, 8), 128),
                ((2, 41, 37, 19), 32)]


@pytest.mark.parametrize("shape,c", TRAIN_SHAPES)
def test_units_cover_every_cotangent_plane_once(shape, c):
    """At the training levels and the ragged batch of 2: every (batch, x,
    y block, z block) in exactly one unit, blocks within one wave, and each
    block's units within one of the others'."""
    bsz, xs, ys, zs = shape
    nxs, xt, units, nper = tc_plan(bsz, xs, ys, zs, c, 7)
    nyb, nzb = cdiv(ys, YT), cdiv(zs, ZT)
    seen = torch.zeros(bsz, xs, nyb, nzb, dtype=torch.int32)
    for u in range(units):
        bi, xsp, yb, zb = unit_of(u, nxs, nyb, nzb)
        seen[bi, xsp * xt:min(xs, xsp * xt + xt), yb, zb] += 1
    assert bool((seen == 1).all())
    assert nper * (c // WARPS) <= H100_SMS and nper <= units
    per_block = [len(range(s, units, nper)) for s in range(nper)]
    assert max(per_block) - min(per_block) <= 1


# ---------------------------------------------------------- depthwise wgrad

def staged(x: torch.Tensor, k: int, rows: int, width: int, shift: int) -> torch.Tensor:
    """``[B, X, nyb, rows, nzb, width, C]``: each unit's staged rows
    ``y0 - shift + r`` and columns ``z0 - shift + i``, zero outside."""
    _, _, ys, zs, _ = x.shape
    gy = torch.arange(cdiv(ys, YT))[:, None] * YT - shift + torch.arange(rows)
    gz = torch.arange(cdiv(zs, ZT))[:, None] * ZT - shift + torch.arange(width)
    mask = ((gy >= 0) & (gy < ys))[:, :, None, None] & ((gz >= 0) & (gz < zs))[None, None]
    s = x.float()[:, :, gy.clamp(0, ys - 1)][:, :, :, :, gz.clamp(0, zs - 1)]
    return s * mask[..., None]


def wgrad_tc_emulated(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's schedule at f32: x, g ``[B, X, Y, Z, C]`` (C % 8 == 0);
    returns ``[k, k, k, C]``."""
    bsz, xs, ys, zs, c = g.shape
    p = k // 2
    nxs, xt, units, nper = tc_plan(bsz, xs, ys, zs, c, k)
    nyb, nzb = cdiv(ys, YT), cdiv(zs, ZT)
    win = staged(x, k, YT + k - 1, ZW, p)  # input windows
    gwin = staged(g, k, YT, ZT, 0)  # cotangent planes
    dw = torch.zeros(k, k, k, c)
    for slot in range(nper):
        e = torch.zeros(k, k, ZW, ZT, c)  # the block's E, all its units
        for u in range(slot, units, nper):
            bi, xsp, yb, zb = unit_of(u, nxs, nyb, nzb)
            x0 = xsp * xt
            ng = min(xs, x0 + xt) - x0
            ring = [None] * k
            for t in range(ng + k - 1):
                xi = x0 - p + t
                if t < ng:
                    ring[t % k] = gwin[bi, x0 + t, yb, :, zb]  # [16 y, 8 j, C]
                if not 0 <= xi < xs:
                    continue
                for dy in range(k):
                    a = win[bi, xi, yb, dy:dy + YT, zb]  # [16 y, 16 i, C]
                    for dx in range(k):
                        if 0 <= t - dx < ng:
                            e[dx, dy] += torch.einsum("yic,yjc->ijc", a, ring[(t - dx) % k])
        for dz in range(k):  # the diagonals
            dw[:, :, dz] += e[:, :, torch.arange(ZT) + dz, torch.arange(ZT)].sum(2)
    return dw


def _operands(rng, shape, cin, c):
    x = torch.from_numpy(rng.standard_normal((*shape, cin)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((*shape, c)).astype(np.float32))
    return x, g


@pytest.mark.parametrize("k", [3, 7])
@pytest.mark.parametrize("shape", [(2, 9, 18, 12), (1, 6, 16, 8)],
                         ids=["ragged-b2", "whole-tiles"])
def test_transposed_band_matches_plain_version(rng, k, shape):
    """Batch 2 on X = 9, Y = 18 and Z = 12 (ragged y and z blocks, several x
    ranges), and one shape of whole blocks; C = 16 (two channel groups)."""
    x, g = _operands(rng, shape, 16, 16)
    want = dwconv3d_wgrad_ref(x, g, k)
    # f32 sums of the same products in another order
    torch.testing.assert_close(wgrad_tc_emulated(x, g, k), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_transposed_band_matches_pallas(rng):
    """k = 3, [1, 8, 8, 8, 32]: the emulation against the TPU default
    (``dwconv3d_wgrad_pallas_v2``), as the JAX package's tests run it."""
    x, g = _operands(rng, (1, 8, 8, 8), 32, 32)
    want = np.asarray(dwconv3d_wgrad_pallas_v2(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                                               3, interpret=True))
    got = wgrad_tc_emulated(x, g, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


# --------------------------------------------------------------------- stem

def stem_halo(x: torch.Tensor, bi, xo, y0, z0, k):
    """The stem tile's halo, both copies: ``[2, k, 16 + k - 1, 24]``, copy 1
    shifted by one element; zero outside the volume and past 16 + k - 1 z."""
    _, xs, ys, zs, _ = x.shape
    p = k // 2
    halo = torch.zeros(2, k, SW_YT + k - 1, SW_ZT + 8, dtype=x.dtype)
    for hx in range(k):
        gx = xo - p + hx
        if not 0 <= gx < xs:
            continue
        for hy in range(SW_YT + k - 1):
            gy = y0 - p + hy
            if not 0 <= gy < ys:
                continue
            for hz in range(SW_ZT + k - 1):
                gz = z0 - p + hz
                if 0 <= gz < zs:
                    halo[0, hx, hy, hz] = halo[1, hx, hy, hz + 1] = x[bi, gx, gy, gz, 0]
    return halo


def test_stem_hankel_fragments_are_aligned_pairs():
    """Lane (g, q) reads a0 / a2 at halo z ``g + 2q`` (+ 8) of row dy = 2p
    and a1 / a3 of row 2p + 1, from copy ``g & 1``: every pair starts on an
    even element (one 4-byte load) and holds A[m][2q], A[m][2q + 1] of the
    Hankel window A[m][z] = xpad[z0 + z + m % 8] of row 2p + m // 8."""
    k = 7
    x = torch.randn(1, 3, 20, 21, 1, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    halo = stem_halo(x, 0, 1, 0, 0, k)
    flat = halo.reshape(-1)
    hy_, hz_ = SW_YT + k - 1, SW_ZT + 8
    copy = k * hy_ * hz_
    rows, cols = fragment_rc()
    lane = torch.arange(32)
    g, q = lane // 4, lane % 4
    for dx in range(k):
        for yy in (0, 5, 15):
            for pr in range((k + 1) // 2):
                for r in range(4):
                    dy = 2 * pr + (r & 1)
                    if dy >= k:
                        continue
                    start = ((g & 1) * copy + (g & 1) + (dx * hy_ + yy + dy) * hz_ + g + 2 * q
                             + 8 * (r >> 1))
                    assert bool((start % 2 == 0).all())
                    m, z = rows[:, r], cols[:, r]
                    for h in range(2):
                        want = halo[0, dx, yy + dy, z + h + m % 8]
                        assert torch.equal(flat[start + h], want)


def stem_wgrad_emulated(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The stem kernel's products at f32: x ``[B, X, Y, Z, 1]``, g
    ``[B, X, Y, Z, 32]``; tiles of 16 y x 16 z, a (dx, dy pair) E of
    ``[16, 32]`` per warp, rows dz (dy = 2p) and 8 + dz (dy = 2p + 1)."""
    bsz, xs, ys, zs, c = g.shape
    pairs = (k + 1) // 2
    e = torch.zeros(k, pairs, 16, c)
    for bi in range(bsz):
        for xo in range(xs):
            for y0 in range(0, ys, SW_YT):
                for z0 in range(0, zs, SW_ZT):
                    halo = stem_halo(x, bi, xo, y0, z0, k)[0]
                    gt = torch.zeros(SW_YT, SW_ZT, c)
                    blk = g[bi, xo, y0:y0 + SW_YT, z0:z0 + SW_ZT].float()
                    gt[:blk.shape[0], :blk.shape[1]] = blk
                    m = torch.arange(16)
                    zz = torch.arange(SW_ZT)
                    for yy in range(min(SW_YT, ys - y0)):
                        for pr in range(pairs):
                            dy = 2 * pr + m // 8  # [16]: the row of each m
                            hy = (yy + dy).clamp(max=SW_YT + k - 2)
                            a = halo[:, hy[:, None], (m % 8)[:, None] + zz[None]]
                            a = a * (dy < k)[:, None]  # [k dx, 16 m, 16 z]
                            e[:, pr] += a.float() @ gt[yy]
    dw = torch.zeros(k, k, k, c)
    for pr in range(pairs):
        for h in range(2):
            if 2 * pr + h < k:
                dw[:, 2 * pr + h] = e[:, pr, 8 * h:8 * h + k]
    return dw


@pytest.mark.parametrize("k", [3, 7])
def test_stem_hankel_matches_plain_version(rng, k):
    """Batch 2, X = 3, Y = 18 and Z = 20 (ragged 16 x 16 tiles)."""
    x, g = _operands(rng, (2, 3, 18, 20), 1, 32)
    want = dwconv3d_wgrad_ref(x, g, k)
    torch.testing.assert_close(stem_wgrad_emulated(x, g, k), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
