"""The bf16 depthwise conv and its weight gradient at k = 9, 11, 13, 15
(``skoots_tpu_torch/csrc/dwconv.cu::dwconv3d_big_kernel``,
``csrc/dwconv_wgrad.cu::dwconv3d_wgrad_big_kernel``), stated in torch and
run at f32 on the CPU against the plain versions; then the plain forward
and its gradients at k = 11 and 13 against JAX's XLA reference.

The forward indexes as follows:

- a block holds CB channels (8 to k = 11, 4 at 13 and 15) and YT output y
  (32 a warp, the warps of a channel stacked: 32 or 64) x 8 output z; the
  launcher splits X into ranges of ``xt`` planes as ``dwconv3d_tc_kernel``'s
  does (:func:`x_split`);
- one band (k = 9) or two (k >= 11): band r holds the taps dz with
  ``8 r <= dz`` (and dz < 8 for band 0 of two) over the 16 window columns
  from ``z0 - k/2 + 8 r``, so the staged row is 16 or 24 columns, the rows
  ``y0 - k/2 ... y0 - k/2 + YT + k - 2``, zero outside the volume;
- the B fragments come from a weight panel: band r of (dx, dy) of block
  channel c is row ``((c k + dx) k + dy) bands + r`` of 16 bf16, tap dz at
  element ``dz - 8 r + 8``, the rows back to back (k = 9's tap 8 at the next
  row's element 0), then a zero row; the panel is stored twice, the second
  copy shifted by one element, and lane (g, q) reads its pairs at elements
  ``2q - g + 8`` and ``2q - g + 16`` of its row from copy ``g & 1``
  (:func:`lane_b_fragments`);
- input plane ``xi`` (step ``t`` of the range) adds ``A[rows dy ..., band
  window] @ T_r[dx, dy]`` into ring slot ``(t - dx) mod k``; after step t,
  slot ``(t + 1) mod k`` is output plane ``xi - k/2``: bias added, stored
  where it lies in the range, then zeroed.

The weight gradient: units (batch, x range, 16 y, 8 z) of an 8-channel
group as ``dwconv3d_wgrad_tc_kernel``'s; the dy of a channel in groups of
DG (3 at k = 9, 1 above), a grid axis, each group's block staging rows
``y0 - k/2 + dy0 ... + 16 + DG - 2``; step t adds, for each dy of the group,
band and dx, ``E_r[dx, dy] += A_r^T G_{t - dx}`` (M = 16 window z from
``z0 - k/2 + 8 r``, N = 8 z, K = 16 y rows); the blocks of slot s walk
units ``s, s + nper, ...`` (:func:`big_plan`), and at the end each writes
``dw[dx, dy, 8 r + i] = sum_j E_r[j + i][j]`` for its taps to the slot's
partial row; the rows add in ``wgrad_reduce_kernel``'s fixed order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels import dwconv as D
from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref, dwconv3d_wgrad_ref

H100_SMS = 132
ZT = 8      # output z of a block (the mma's N)
ROW = 16    # a band's tap row in the panel
BIG_K = (9, 11, 13, 15)
T = torch.from_numpy


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


def geometry(k):
    """(bands, channels a block, output y of a block) of the forward."""
    nb = 1 if k <= 9 else 2
    cb = 8 if k <= 11 else 4
    return nb, cb, 32 * (8 // cb)


def band_range(k, r):
    """The taps dz of band r: [8 r, end)."""
    nb = geometry(k)[0]
    return 8 * r, (k if nb == 1 or r == 1 else 8)


# ------------------------------------------------------------------ the panel

def panel(w: torch.Tensor, c0: int) -> torch.Tensor:
    """Copy 0 of a block's weight panel (flat, ``ROWS * 16`` elements) for
    the channels ``c0 ... c0 + CB - 1`` of ``w`` ``[k, k, k, C]``."""
    k = w.shape[0]
    nb, cb, _ = geometry(k)
    rows = cb * k * k * nb + 1
    flat = torch.zeros(rows * ROW + ROW, dtype=w.dtype)
    for r in range(nb):
        lo, hi = band_range(k, r)
        c, dx, dy, dz = torch.meshgrid(torch.arange(cb), torch.arange(k), torch.arange(k),
                                       torch.arange(lo, hi), indexing="ij")
        rho = ((c * k + dx) * k + dy) * nb + r
        flat[rho * ROW + dz - 8 * r + 8] = w[dx, dy, dz, c0 + c]
    assert not bool(flat[rows * ROW:].any())  # nothing past the zero row
    return flat[:rows * ROW]


def lane_b_fragments(copy0: torch.Tensor, rho: torch.Tensor) -> tuple:
    """Each lane's (b0, b1) pairs of the panel rows ``rho`` (``[*R, 32, 2,
    2]``), read as the kernel reads them, and the (copy, element) of each
    32-bit load: lane (g, q) reads elements 2q - g + 8 (b0) and 2q - g + 16
    (b1) of its row from copy g & 1, whose element e + 1 holds copy 0's
    element e."""
    n = copy0.numel()
    copy1 = torch.cat([torch.zeros(1, dtype=copy0.dtype), copy0])
    lane = torch.arange(32)
    g, q = lane // 4, lane % 4
    odd = (g % 2 == 1)
    regs = torch.empty(*rho.shape, 32, 2, 2, dtype=copy0.dtype)
    loads = []
    for reg in range(2):
        m = rho[..., None] * ROW + 2 * q - g + 8 + 8 * reg  # copy 0 element of the low half
        e = torch.where(odd, m + 1, m)                      # the element read in copy g & 1
        assert bool((e % 2 == 0).all()) and int(m.min()) >= 0 and int(m.max()) + 1 < n
        for h in range(2):
            regs[..., reg, h] = torch.where(odd, copy1[e + h], copy0[e + h])
        loads.append((odd.long(), e))
    return regs, loads


def b_matrix(regs: torch.Tensor) -> torch.Tensor:
    """The 16 x 8 B of an ``m16n8k16`` from the lanes' fragments ``[*, 32,
    2, 2]``: b0 = rows 2q, 2q + 1 of column g, b1 = rows 2q + 8, 2q + 9."""
    b = torch.zeros(*regs.shape[:-3], 16, 8, dtype=regs.dtype)
    lane = torch.arange(32)
    for reg in range(2):
        for h in range(2):
            b[..., 2 * (lane % 4) + 8 * reg + h, lane // 4] = regs[..., reg, h]
    return b


def banded(w: torch.Tensor, k: int, r: int) -> torch.Tensor:
    """``[k, k, 16, 8, C]``: T_r[dx, dy, i, j] = w[dx, dy, 8 r + i - j] for
    the taps of band r (0 elsewhere)."""
    lo, hi = band_range(k, r)
    dz = 8 * r + torch.arange(16)[:, None] - torch.arange(ZT)[None]
    on = (dz >= lo) & (dz < hi)
    return w[:, :, dz.clamp(0, k - 1)] * on[..., None]


def panel_taps(w: torch.Tensor) -> list:
    """Per band, ``[k, k, 16, 8, C]``: the B matrices every lane reads from
    every channel group's panel."""
    k, c = w.shape[0], w.shape[-1]
    nb, cb, _ = geometry(k)
    out = [torch.zeros(k, k, 16, ZT, c, dtype=w.dtype) for _ in range(nb)]
    rho = torch.arange(cb * k * k * nb).reshape(cb, k, k, nb)
    for c0 in range(0, c, cb):
        regs, _ = lane_b_fragments(panel(w, c0), rho)
        mats = b_matrix(regs)  # [cb, k, k, nb, 16, 8]
        for r in range(nb):
            out[r][..., c0:c0 + cb] = mats[:, :, :, r].permute(1, 2, 3, 4, 0)
    return out


@pytest.mark.parametrize("k", BIG_K)
def test_panel_reads_give_the_banded_taps(k):
    """Every lane's aligned pairs from the shifted copies, over every (dx,
    dy, band) row of a block, make the banded T of that band: each tap once
    across the bands, reads past a row seeing only zeros."""
    gen = torch.Generator().manual_seed(k)
    nb, cb, _ = geometry(k)
    w = torch.randn(k, k, k, cb, generator=gen, dtype=torch.float64)
    got = panel_taps(w)
    for r in range(nb):
        torch.testing.assert_close(got[r], banded(w, k, r), rtol=0, atol=0)
    owners = [sum(lo <= dz < hi for lo, hi in (band_range(k, r) for r in range(nb)))
              for dz in range(k)]
    assert owners == [1] * k


@pytest.mark.parametrize("k", BIG_K)
def test_panel_loads_are_bank_conflict_free(k):
    """The two copies start 16 banks apart (``DwBig::COPY``), so each 32-bit
    load of a warp touches distinct banks for distinct words."""
    nb, cb, _ = geometry(k)
    rows = cb * k * k * nb + 1
    copy = cdiv(rows * ROW + 1, 64) * 64 + 32
    _, loads = lane_b_fragments(torch.zeros(rows * ROW), torch.arange(rows - 1))
    for which, e in loads:
        for words in ((which * copy + e) // 2).tolist():  # a warp's load of one row
            banks = {}
            for wd in words:
                banks.setdefault(wd % 32, set()).add(wd)
            assert all(len(s) == 1 for s in banks.values())


# ---------------------------------------------------------------- the forward

def split_x(cols, xs, target, k, min_xt):
    """common.cuh::split_x: (nxs, xt, units, per_block), ``cols`` units a
    range dealt to ``target`` blocks, the split whose blocks finish soonest
    (a unit of xt planes costs xt + k - 1 + 2), ranges of at least
    ``min_xt`` planes but the last."""
    best = None
    for nxs in range(1, cdiv(xs, min_xt) + 1):
        xt = cdiv(xs, nxs)
        if cdiv(xs, xt) != nxs:
            continue
        units = cols * nxs
        per_block = cdiv(units, target)
        cost = per_block * (xt + k - 1 + 2)
        if best is None or cost < best[0]:
            best = (cost, nxs, xt, units, per_block)
    return best[1:]


def x_split(bsz, xs, ys, zs, c, k, sms=H100_SMS):
    """The launcher's (ranges, planes a range): one block an SM, ranges of
    at least 8 planes but the last."""
    _, cb, yt = geometry(k)
    return split_x(bsz * cdiv(ys, yt) * cdiv(zs, ZT) * (c // cb), xs, sms, k, 8)[:2]


def staged(x: torch.Tensor, p: int, rows: int, row0: int, width: int, step_y: int,
           step_z: int) -> torch.Tensor:
    """``[B, X, nyb, rows, nzb, width, C]``: each block's staged window of
    every x plane, rows ``yb step_y - p + row0 + r``, columns ``zb step_z -
    p + s``, zero outside the volume."""
    _, _, ys, zs, _ = x.shape
    gy = torch.arange(cdiv(ys, step_y))[:, None] * step_y - p + row0 + torch.arange(rows)
    gz = torch.arange(cdiv(zs, step_z))[:, None] * step_z - p + torch.arange(width)
    mask = ((gy >= 0) & (gy < ys))[:, :, None, None] & ((gz >= 0) & (gz < zs))[None, None]
    s = x.float()[:, :, gy.clamp(0, ys - 1)][:, :, :, :, gz.clamp(0, zs - 1)]
    return s * mask[..., None]


def dwconv_big_emulated(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``dwconv3d_big_kernel``'s schedule at f32, B from the panel reads."""
    bsz, xs_, ys, zs, _ = x.shape
    k, c = w.shape[0], w.shape[-1]
    p = k // 2
    nb, _, yt = geometry(k)
    taps = panel_taps(w.float())
    win = staged(x, p, yt + k - 1, 0, 8 + 8 * nb, yt, ZT)
    nyb, nzb = win.shape[2], win.shape[4]
    out = torch.full((bsz, xs_, nyb * yt, nzb * ZT, c), float("nan"))
    nxs, xt = x_split(bsz, xs_, ys, zs, c, k)
    for rg in range(nxs):
        lo, hi = rg * xt, min(xs_, rg * xt + xt)
        acc = [torch.zeros(bsz, nyb, yt, nzb, ZT, c) for _ in range(k)]
        for t in range(hi - lo + k - 1):
            xi = lo - p + t
            if 0 <= xi < xs_:
                for dy in range(k):
                    for r in range(nb):
                        a = win[:, xi, :, dy:dy + yt, :, 8 * r:8 * r + 16]
                        part = torch.einsum("bnyzic,xijc->xbnyzjc", a, taps[r][:, dy])
                        for dx in range(k):
                            acc[(t - dx) % k] += part[dx]
            xo, s = xi - p, (t + 1) % k
            if xo >= lo:
                out[:, xo] = (acc[s] + b.float()).reshape(bsz, nyb * yt, nzb * ZT, c)
            acc[s] = torch.zeros_like(acc[s])
    return out[:, :, :ys, :zs]


def _inputs(rng, shape, c, k):
    x = rng.standard_normal((*shape, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return T(x), T(w), T(b)


@pytest.mark.parametrize("c", [8, 16, 48])
@pytest.mark.parametrize("k", BIG_K)
def test_big_forward_matches_plain_version(rng, k, c):
    """X = 11 (split into ranges of 6 and 5 where the grid is small), Y = 37
    (a ragged second y block, or one block of 64 rows), Z = 13 (a ragged
    z block)."""
    x, w, b = _inputs(rng, (1, 11, 37, 13), c, k)
    # f32 sums of the same k^3 products in another order
    torch.testing.assert_close(dwconv_big_emulated(x, w, b), dwconv3d_ref(x, w, b),
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("k", BIG_K)
def test_x_split_covers_the_planes(k):
    """The ranges cover X once, each at least 8 planes but the last, at the
    k = 9 / 11 models' tile levels and the training crop's; the 256^2 x 96
    level in one range (three waves of blocks already)."""
    for (bsz, xs, ys, zs), c in (((1, 256, 256, 96), 32), ((1, 128, 128, 48), 64),
                                 ((1, 64, 64, 24), 128), ((1, 96, 96, 32), 32),
                                 ((1, 24, 24, 8), 128)):
        nxs, xt = x_split(bsz, xs, ys, zs, c, k)
        assert (nxs - 1) * xt < xs <= nxs * xt and (nxs == 1 or xt >= 8)
        assert nxs == 1 or xs < 256


# -------------------------------------------------------- the weight gradient

def wgrad_geometry(k):
    """(bands, dy of a group, dy groups)."""
    nb = 1 if k <= 9 else 2
    dg = 3 if k == 9 else 1
    return nb, dg, k // dg


def big_plan(bsz, xs, ys, zs, c, k, sms=H100_SMS, per_sm=1):
    """The launcher's (nxs, xt, units, nper): blocks a (channel group, dy
    group) one wave of the card, then :func:`split_x` of the units."""
    groups = (c // 8) * wgrad_geometry(k)[2]
    target = max(1, sms * per_sm // groups)
    nxs, xt, units, per_block = split_x(bsz * cdiv(ys, 16) * cdiv(zs, ZT), xs, target, k, 1)
    return nxs, xt, units, cdiv(units, per_block)


def reduce_rows(partial: torch.Tensor) -> torch.Tensor:
    """``wgrad_reduce_kernel``: row group rg adds rows rg, rg + 8, ... in
    order, then the 8 sums add in the order rg = 0, 1, ..."""
    sums = [torch.zeros_like(partial[0]) for _ in range(8)]
    for r in range(partial.shape[0]):
        sums[r % 8] = sums[r % 8] + partial[r]
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def wgrad_big_emulated(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """``dwconv3d_wgrad_big_kernel``'s schedule at f32, then the reduce."""
    bsz, xs_, ys, zs, c = x.shape
    p = k // 2
    nb, dg, ngr = wgrad_geometry(k)
    nxs, xt, units, nper = big_plan(bsz, xs_, ys, zs, c, k)
    nyb, nzb = cdiv(ys, 16), cdiv(zs, ZT)
    gwin = staged(g, 0, 16, 0, ZT, 16, ZT)  # rows y0 + y, columns z0 + j
    partial = torch.full((nper, k, k, k, c), float("nan"))
    for grp in range(ngr):
        dy0 = grp * dg
        win = staged(x, p, 16 + dg - 1, dy0, 8 + 8 * nb, 16, ZT)
        # E of every unit: [units, dx, dy - dy0, band, 16, 8, C]
        e = torch.zeros(bsz, nxs, nyb, nzb, k, dg, nb, 16, ZT, c)
        for xsp in range(nxs):
            lo = xsp * xt
            ng = min(xs_, lo + xt) - lo
            for t in range(ng + k - 1):
                xi = lo - p + t
                if not 0 <= xi < xs_:
                    continue
                gs = torch.stack([gwin[:, lo + t - dx] if 0 <= t - dx < ng
                                  else torch.zeros_like(gwin[:, 0]) for dx in range(k)])
                for d in range(dg):
                    for r in range(nb):
                        a = win[:, xi, :, d:d + 16, :, 8 * r:8 * r + 16]
                        e[:, xsp, :, :, :, d, r] += torch.einsum(
                            "bnyzic,xbnyzjc->bnzxijc", a, gs)
        e = e.reshape(units, k, dg, nb, 16, ZT, c)
        for s in range(nper):
            es = e[s::nper].sum(0)  # the slot's units, in its order
            for r in range(nb):
                lo_dz, hi_dz = band_range(k, r)
                for dz in range(lo_dz, hi_dz):
                    i = dz - 8 * r
                    diag = es[:, :, r, torch.arange(ZT) + i, torch.arange(ZT)].sum(2)
                    partial[s, :, dy0:dy0 + dg, dz] = diag
    assert not bool(partial.isnan().any())  # every row written whole
    return reduce_rows(partial)


@pytest.mark.parametrize("c", [8, 16, 48])
@pytest.mark.parametrize("k", BIG_K)
def test_big_wgrad_matches_plain_version(rng, k, c):
    """Batch 2, X = 11, Y = 21 (a ragged second y block), Z = 13 (a ragged
    z block): every dy group, band and diagonal, the slots' partial rows and
    the fixed-order reduce."""
    x = T(rng.standard_normal((2, 11, 21, 13, c)).astype(np.float32))
    g = T(rng.standard_normal((2, 11, 21, 13, c)).astype(np.float32))
    # f32 sums of the same products in another order
    torch.testing.assert_close(wgrad_big_emulated(x, g, k), dwconv3d_wgrad_ref(x, g, k),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("k", BIG_K)
def test_big_plan_units_cover_the_cotangent_once(k):
    """At the training levels of the k = 9 / 11 models and a ragged batch:
    every (batch, x, y block, z block) in one unit, the blocks within one
    wave, the slots' unit counts within one of each other."""
    for (bsz, xs, ys, zs), c in (((1, 96, 96, 32), 32), ((1, 48, 48, 16), 64),
                                 ((1, 24, 24, 8), 128), ((2, 11, 21, 13), 48)):
        nxs, xt, units, nper = big_plan(bsz, xs, ys, zs, c, k)
        nyb, nzb = cdiv(ys, 16), cdiv(zs, ZT)
        seen = torch.zeros(bsz, xs, nyb, nzb, dtype=torch.int32)
        for u in range(units):
            zb, r = u % nzb, u // nzb
            yb, r = r % nyb, r // nyb
            bi, xsp = r // nxs, r % nxs
            seen[bi, xsp * xt:min(xs, xsp * xt + xt), yb, zb] += 1
        assert bool((seen == 1).all())
        assert nper <= min(units, max(1, H100_SMS // ((c // 8) * wgrad_geometry(k)[2])))
        per_slot = [len(range(s, units, nper)) for s in range(nper)]
        assert max(per_slot) - min(per_slot) <= 1


# ------------------------------------------------------------- against JAX

@pytest.mark.parametrize("k", [11, 13])
def test_dwconv_ref_matches_jax(rng, k):
    """The plain depthwise conv against JAX's XLA reference at k = 11 and
    13; f32 sums of k^3 products in another order, 1e-4."""
    c = 16
    x = rng.standard_normal((1, 9, 10, 12, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(D._xla_dwconv_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(dwconv3d_ref(T(x), T(w), T(b)).numpy(), want,
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k", [11, 13])
def test_dwconv_grads_match_jax(rng, k):
    """k = 11 and 13: the plain weight gradient and the autograd of the
    whole wrapper (input gradient: the forward on the cotangent with
    flipped taps) against JAX's XLA vjp; 1e-4."""
    c = 8
    x = rng.standard_normal((2, 8, 9, 10, c)).astype(np.float32)
    g = rng.standard_normal((2, 8, 9, 10, c)).astype(np.float32)
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
