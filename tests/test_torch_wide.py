"""The block tail and LN head at every width JAX's kernels take, as the
Hopper kernels schedule them (``skoots_tpu_torch/csrc/mlp.cu``,
``csrc/lnhead.cu``), stated in torch and run on the CPU.

- The kernels' shared-memory layouts, mirrored from their launchers, fit
  the H100's 227 KB at every width they serve; the hidden chunks are whole
  pairs of 16-column steps, and every row stride keeps ``ldmatrix`` free of
  bank conflicts.
- ``tail_class_kernel`` (C <= 128 beside the templates) and
  ``tail_staged_kernel`` (C > 128): rows in their tiles, C padded to the
  16-wide k-step with zeros in the LayerNorm output and w1, the hidden
  chunks (resident or a ring of 64 columns; the staged kernel's 64-column
  chunks split between the two warps of a row group), GEMM2's n8 tiles
  (an odd count; the staged kernel's split between the pair). Every sum is
  taken in f64 and rounded once, so the schedule must equal the plain
  version with f64 sums bit for bit: a misplaced row, column, chunk or pad
  would show.
- ``ln_head_class_kernel``: C padded to the k-step, N in 64-column chunks,
  ``h @ W`` and ``|h| @ |W|`` in k16 steps, the recompute test with
  ``ERR = (C + 36 KS) 2^-24`` and directed roundings, the flagged sums
  recomputed in order: bit-equal to ``ln_head_ref``.
- The f32 kernels' chunking: the head's W chunk (bit-equal: no sum split),
  the tail's 256-column hidden chunks and 8 x 4 thread blocks.
- The plain tail and head against JAX's Pallas kernels in interpret mode at
  48, 96, 192, and the 48-96-192 UNeXT3D against the flax model.

The kernels themselves are held to the plain versions on the card
(``tests/test_torch_infer_cuda.py``, ``chip_smoke.py``), with their route
query.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.config import get_cfg_defaults as jax_defaults
from skoots_tpu.kernels.lnhead import _ln_head_call
from skoots_tpu.kernels.mlp import _mlp_call
from skoots_tpu.models import init_model as jax_init_model
from skoots_tpu_torch import config as C
from skoots_tpu_torch.kernels.lnhead import ln_head_ref
from skoots_tpu_torch.kernels.mlp import _rnd, layer_norm_rows, mlp_block_tail_ref
from skoots_tpu_torch.models import cfg_to_model, load_flax_params

T = torch.from_numpy
BF = torch.bfloat16
SMEM_OPTIN = 232448  # a block's shared memory on the H100
WIDTHS = [8, 24, 40, 48, 96, 192, 256]
TEMPLATES = (16, 32, 64, 128)  # the tensor-core templates' widths
ALL = range(8, 257, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pad16(c: int) -> int:
    return -(-c // 16) * 16


# ---- the launchers' layouts ---------------------------------------------------


def class_layout(c: int, stream: bool, warps: int = 8) -> dict:
    """``csrc/mlp.cu::class_layout``: bytes, strides in elements."""
    cp, h = _pad16(c), 4 * c
    hc = 64 if stream else h
    w1s, w2s, hs = hc + 8, cp + 8, cp + 8
    chunk = cp * w1s * 2 + hc * w2s * 2
    tile = warps * 16 * c * 2
    smem = (2 if stream else 1) * chunk + 2 * tile + warps * 16 * hs * 2
    return dict(cp=cp, hc=hc, nch=-(-h // hc), strides=(w1s, w2s, hs), smem=smem)


def tail_class_plan(c: int) -> dict:
    """Resident where the weights fit beside the tiles, else streamed."""
    lay = class_layout(c, False)
    return lay if lay["smem"] <= SMEM_OPTIN else class_layout(c, True)


def staged_layout(c: int) -> dict:
    """``csrc/mlp.cu::TailStaged<256>::layout``: 64-row tiles, 64-column
    hidden chunks through a ring of two."""
    cp, h, hc, rows = _pad16(c), 4 * c, 64, 64
    w1s, w2s, hs, hid = hc + 8, cp + 8, cp + 8, hc + 8
    chunk = cp * w1s * 2 + hc * w2s * 2
    smem = 2 * chunk + rows * hs * 2 + rows * hid * 2 + (h + 2 * c) * 4
    return dict(cp=cp, hc=hc, nch=-(-h // hc), strides=(w1s, w2s, hs, hid), smem=smem)


def head_layout(c: int, cmax: int) -> dict:
    """``csrc/lnhead.cu::HeadClass<CMAX, 8>::layout``: 64-column chunks."""
    warps = 4 if cmax >= 128 else 8
    cp, nw = _pad16(c), 64
    xs, ws, ts, os_ = cp + 8, nw + 8, cp + 8, nw + 8
    smem = (cp * ws * 2 + nw * ts * 2 + (2 * cp + nw) * 4 + warps * 2 * 32 * xs * 2
            + warps * 16 * os_ * 2 + warps * 16 * nw * 2)
    return dict(cp=cp, strides=(xs, ws, ts, os_), smem=smem)


def f32_head_chunk(c: int, n: int) -> int:
    """``csrc/lnhead.cu::f32_chunk``: W's columns in shared memory."""
    most = 131072 // (4 * c) // 4 * 4
    return min(-(-n // 4) * 4, most)


def _odd16(stride_elems: int) -> bool:
    """16-byte rows an odd multiple of 16 bytes apart: the 8 rows of an
    ldmatrix fall in distinct banks."""
    return (stride_elems * 2) % 16 == 0 and (stride_elems * 2 // 16) % 2 == 1


def test_layouts_fit_at_every_width():
    """Every width each kernel serves fits a block's shared memory; the
    class tail keeps its weights resident up to C = 96 (the wide model's
    96 among them) and streams above; hidden chunks are multiples of 32
    columns (whole pairs of 16-column steps: the software pipeline's two a
    turn); every ldmatrix stride is an odd multiple of 16 bytes."""
    resident = []
    for c in ALL:
        if c in TEMPLATES:
            continue
        if c <= 128:
            lay = tail_class_plan(c)
            if lay["hc"] == 4 * c:
                resident.append(c)
        else:
            lay = staged_layout(c)
        assert lay["smem"] <= SMEM_OPTIN, (c, lay)
        last = 4 * c - (lay["nch"] - 1) * lay["hc"]
        assert last % 32 == 0 and 0 < last <= lay["hc"], c
        assert all(_odd16(s) for s in lay["strides"]), (c, lay["strides"])
    assert resident == [c for c in ALL if c <= 96 and c not in TEMPLATES]
    for c in ALL:
        cmax = next(m for m in (32, 64, 128, 256) if c <= m)
        lay = head_layout(c, cmax)
        assert lay["smem"] <= SMEM_OPTIN, (c, lay)
        assert all(_odd16(s) for s in lay["strides"]), c
        nc = f32_head_chunk(c, 256)
        assert nc % 4 == 0 and c * nc * 4 + 32 * c * 4 <= SMEM_OPTIN


# ---- the block tail ------------------------------------------------------------


def _gelu(a):
    return 0.5 * a * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0))))


def _mm(a, b):
    """A sum of exact products in f64, rounded once to f32."""
    return (a.double() @ b.double()).float()


def tail_ref64(x, sc, ls, lb, w1, b1, w2, b2, g):
    """``mlp_block_tail_ref`` with each matmul's sums in f64, rounded once."""
    dt = x.dtype
    h = layer_norm_rows(x, ls, lb, dt)
    a = _rnd(_mm(h, _rnd(w1.float(), dt)), dt)
    a = _rnd(_gelu(_rnd(a + _rnd(b1.float(), dt), dt)), dt)
    y = _rnd(_mm(a, _rnd(w2.float(), dt)), dt)
    y = _rnd(_rnd(y + _rnd(b2.float(), dt), dt) * _rnd(g.float(), dt), dt)
    return (sc.float() + y).to(dt)


def _tail_operands(dt, c):
    """The parameters as the wrapper hands them over: weights in ``dt``,
    the vectors rounded to ``dt`` (as f32)."""
    return lambda ls, lb, w1, b1, w2, b2, g: (
        *(_rnd(t, dt) for t in (ls, lb)), _rnd(w1.float(), dt), _rnd(b1, dt),
        _rnd(w2.float(), dt), _rnd(b2, dt), _rnd(g, dt))


def _hidden_chunk(h_rows, w1p, b1, c0, hc, dt):
    """GEMM1 and its epilogue for hidden columns c0 ... c0 + hc - 1 of rows
    whose LayerNorm output ``h_rows`` is zero-padded to Cp columns, in the
    kernels' 16-wide k-steps over the padded k (each step's exact sum is
    added to the f32 running sum the way an f64 sum rounded once would
    be: the steps' sums are exact here, so the order cannot show)."""
    a = _mm(h_rows, w1p[:, c0:c0 + hc])
    a = _rnd(_rnd(a, dt) + b1[c0:c0 + hc], dt)
    return _rnd(_gelu(a), dt)


def tail_class_schedule(x, sc, ls, lb, w1, b1, w2, b2, g):
    """``tail_class_kernel``'s order of work, every sum exact: 128-row block
    tiles of 8 warps x 16 rows (the last padded with zero rows that are
    never stored), the LayerNorm zero-padded to Cp columns, w1 to Cp rows,
    the hidden chunks of the launcher's plan, GEMM2's n8 tiles in x4 pairs
    (an odd count's last pair computes a tile it never stores), the
    epilogue, then out = round(shortcut + y) for the rows below V."""
    dt = x.dtype
    v, c = x.shape
    lay = tail_class_plan(c)
    cp, hc, nch = lay["cp"], lay["hc"], lay["nch"]
    ls, lb, w1, b1, w2, b2, g = _tail_operands(dt, c)(ls, lb, w1, b1, w2, b2, g)
    w1p = torch.zeros(cp, 4 * c)
    w1p[:c] = w1
    nt2 = c // 8
    w2p = torch.zeros(4 * c, 8 * (nt2 + nt2 % 2))  # the x4 pair reads 8 more columns
    w2p[:, :c] = w2
    out = torch.full((v, c), float("nan"))
    for t0 in range(0, v, 128):
        for w0 in range(t0, t0 + 128, 16):  # a warp's 16 rows
            rows = torch.zeros(16, c, dtype=dt)
            n = max(0, min(16, v - w0))
            rows[:n] = x[w0:w0 + n]
            h = torch.zeros(16, cp)
            h[:, :c] = layer_norm_rows(rows, ls, lb, dt)
            acc2 = torch.zeros(16, w2p.shape[1], dtype=torch.float64)  # exact sums
            for ch in range(nch):
                c0 = ch * hc
                hcc = min(hc, 4 * c - c0)
                for p in range(0, hcc, 16):  # a 16-column step: GEMM2's k-step p
                    a = _hidden_chunk(h, w1p, b1, c0 + p, 16, dt)
                    acc2 += a.double() @ w2p[c0 + p:c0 + p + 16].double()
            y = _rnd(_rnd(_rnd(_rnd(acc2[:, :c].float(), dt) + b2, dt) * g, dt), dt)
            if n:
                out[w0:w0 + n] = (sc[w0:w0 + n].float() + y[:n]).to(dt).float()
    return out.to(dt)


def tail_staged_schedule(x, sc, ls, lb, w1, b1, w2, b2, g):
    """``tail_staged_kernel``'s order of work, every sum exact: 64-row tiles
    of four 16-row groups, two warps a group. For each 64-column hidden
    chunk (the last 32 where C % 16 == 8), warp ``part`` computes GEMM1 and
    its epilogue for columns ``part * hcc / 2 ...`` of its group into the
    staged chunk; then each warp adds the chunk's products (summed from
    zero) into its own n8 output tiles, ``[0, ceil(NT / 2))`` for part 0
    and the rest for part 1."""
    dt = x.dtype
    v, c = x.shape
    lay = staged_layout(c)
    cp, hcw, nch = lay["cp"], lay["hc"], lay["nch"]
    ls, lb, w1, b1, w2, b2, g = _tail_operands(dt, c)(ls, lb, w1, b1, w2, b2, g)
    w1p = torch.zeros(cp, 4 * c)
    w1p[:c] = w1
    nt2 = c // 8
    half = (nt2 + 1) // 2
    tiles = ((0, half), (half, nt2 - half))
    out = torch.full((v, c), float("nan"))
    for t0 in range(0, v, 64):
        for g0 in range(t0, t0 + 64, 16):  # a row group: two warps
            rows = torch.zeros(16, c, dtype=dt)
            n = max(0, min(16, v - g0))
            rows[:n] = x[g0:g0 + n]
            h = torch.zeros(16, cp)
            h[:, :c] = layer_norm_rows(rows, ls, lb, dt)
            acc2 = [torch.zeros(16, 8 * nt, dtype=torch.float64) for _, nt in tiles]
            for ch in range(nch):
                c0 = ch * hcw
                hcc = min(hcw, 4 * c - c0)
                staged = torch.full((16, hcc), float("nan"))
                for part in (0, 1):
                    for pg in range(hcc // 32):
                        col = part * (hcc // 2) + pg * 16
                        staged[:, col:col + 16] = _hidden_chunk(h, w1p, b1, c0 + col, 16, dt)
                assert not bool(staged.isnan().any())
                for part, (f, nt) in enumerate(tiles):
                    acc2[part] += staged.double() @ w2[c0:c0 + hcc, 8 * f:8 * (f + nt)].double()
            y = torch.cat(acc2, dim=1).float()
            y = _rnd(_rnd(_rnd(_rnd(y, dt) + b2, dt) * g, dt), dt)
            if n:
                out[g0:g0 + n] = (sc[g0:g0 + n].float() + y[:n]).to(dt).float()
    return out.to(dt)


def _tail_inputs(rng, v, c):
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return (f(v, c).to(BF), (f(v, c) * 0.1).to(BF), f(c) * 0.1 + 1.0, f(c) * 0.1,
            (f(c, 4 * c) / c ** 0.5).to(BF), f(4 * c) * 0.1,
            (f(4 * c, c) / (2 * c ** 0.5)).to(BF), f(c) * 0.1, torch.full((c,), 0.5))


@pytest.mark.parametrize("c", WIDTHS)
def test_tail_schedule_is_the_function(c):
    """At a V no tile divides: the width class's schedule (or the staged
    kernel's above 128) with exact sums equals the plain version with
    exact sums bit for bit, and every output is written; the plain version
    itself stays within 2 bf16 ulps of both (its f32 sums in another
    order), the card's bound for the kernels."""
    args = _tail_inputs(np.random.default_rng(c), 16 * 13 + 9, c)
    want = tail_ref64(*args)
    sched = tail_class_schedule if c <= 128 else tail_staged_schedule
    got = sched(*args)
    assert got.dtype == BF and not bool(got.float().isnan().any())
    assert torch.equal(got, want)
    plain = mlp_block_tail_ref(*args)
    r = want.float().abs()
    scale = torch.maximum(r, r.square().mean().sqrt())
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(scale)[1] - 8)
    assert float(((plain.float() - want.float()).abs() / ulp).max()) <= 2.0


def test_staged_split_covers_every_tile():
    """The pair's n8 tiles partition the output at every C > 128 (odd
    counts included), and each warp's x4 pairs read at most 8 columns past
    C, inside the padded w2 row (Cp + 8)."""
    for c in range(136, 257, 8):
        nt2 = c // 8
        half = (nt2 + 1) // 2
        seen = []
        for f, nt in ((0, half), (half, nt2 - half)):
            seen += list(range(f, f + nt))
            last_col = 8 * (f + 2 * (-(-nt // 2))) - 1
            assert last_col < _pad16(c) + 8
        assert seen == list(range(nt2)), c


# ---- the LN head -----------------------------------------------------------------


def _round_down(d: torch.Tensor) -> torch.Tensor:
    """The f64 values rounded to f32 toward -inf."""
    f = d.float()
    return torch.where(f.double() > d, torch.nextafter(f, torch.full_like(f, -math.inf)), f)


def _round_up(d: torch.Tensor) -> torch.Tensor:
    f = d.float()
    return torch.where(f.double() < d, torch.nextafter(f, torch.full_like(f, math.inf)), f)


def head_err(c: int) -> float:
    """``HeadClass::layout``'s ERR: (C + 36 KS) 2^-24, KS the k-steps."""
    return float(np.float32((c + 36 * (_pad16(c) // 16)) / 2 ** 24))


def flag_interval(acc: torch.Tensor, mag: torch.Tensor, c: int,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """The class kernel's recompute test, err = ERR * mag in f32: the
    outputs y(s) = bf16(bf16(s) + b) of sum - err rounded down and of
    sum + err rounded up differ (y is monotonic in s)."""
    err = (mag * head_err(c)).float()
    lo = _round_down(acc.double() - err.double())
    hi = _round_up(acc.double() + err.double())
    b = torch.zeros(acc.shape[-1]) if b is None else b
    return (lo.to(BF).float() + b).to(BF) != (hi.to(BF).float() + b).to(BF)


def ln_head_class_schedule(x, ls, lb, w, b, recompute=True):
    """``ln_head_class_kernel``'s order of work for bf16 ``x`` ``[V, C]``:
    32-row warp tiles (zero rows past V, never stored), the rows
    zero-padded to Cp columns, N in 64-column chunks (a grid row each), W's
    chunk zero-padded to Cp rows and 64 columns, ``h @ W`` and ``|h| @ |W|``
    a k16 step at a time (a step's exact sum rounded to f32, then added in
    f32), the flagged sums recomputed in order. Also the share of the
    stored sums it recomputed."""
    v, c = x.shape
    n = w.shape[1]
    cp = _pad16(c)
    rows = -(-v // 32) * 32
    xp = torch.cat([x, torch.zeros((rows - v, c), dtype=x.dtype)])
    h = torch.zeros(rows, cp)
    h[:, :c] = layer_norm_rows(xp, ls.to(BF).float(), lb.to(BF).float(), BF)
    out = torch.full((v, n), float("nan"))
    redone = 0
    for n0 in range(0, n, 64):
        ncw = min(64, n - n0)
        wp = torch.zeros(cp, 64)
        wp[:c, :ncw] = w[:, n0:n0 + ncw].to(BF).float()
        bp = torch.zeros(64)
        bp[:ncw] = b[n0:n0 + ncw].to(BF).float()
        acc = torch.zeros(rows, 64)
        mag = torch.zeros(rows, 64)
        for k0 in range(0, cp, 16):
            acc = acc + _mm(h[:, k0:k0 + 16], wp[k0:k0 + 16])
            mag = mag + _mm(h[:, k0:k0 + 16].abs(), wp[k0:k0 + 16].abs())
        redo = flag_interval(acc, mag, c, bp) & recompute
        redo[v:] = False
        redo[:, ncw:] = False
        rr, cc = redo.nonzero(as_tuple=True)
        in_order = h[rr, 0] * wp[0, cc]
        for k in range(1, c):
            in_order = in_order + h[rr, k] * wp[k, cc]
        acc[rr, cc] = in_order
        redone += int(redo.sum())
        out[:, n0:n0 + ncw] = (acc.to(BF).float() + bp).to(BF).float()[:v, :ncw]
    return out.to(BF), redone / (v * n)


def _head_inputs(rng, v, c, n):
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return (f(v, c).to(BF), f(c) * 0.1 + 1.0, f(c) * 0.1, (f(c, n) / np.sqrt(c)).to(BF),
            f(n) * 0.1)


@pytest.mark.parametrize("n", ["C", 200, 256])
@pytest.mark.parametrize("c", WIDTHS)
def test_ln_head_schedule_equals_plain_version(c, n):
    """At a V with a partial 32-row tile: bit-equal to ``ln_head_ref``; the
    recomputed share grows with C as the bound does (4% at C = 48, 36% at
    256), below 2% + C / 640."""
    n = c if n == "C" else n
    x, ls, lb, w, b = _head_inputs(np.random.default_rng(c * 1000 + n), 32 * 9 + 7, c, n)
    got, share = ln_head_class_schedule(x, ls, lb, w, b)
    ref = ln_head_ref(x, ls, lb, w, b)
    assert got.dtype == BF and got.shape == ref.shape
    assert torch.equal(got, ref)
    assert share < 0.02 + c / 640


def test_recompute_repairs_the_flipped_roundings_at_48():
    """The wide model's head, C = N = 48, over 240,000 sums: the k16 order
    rounds some sums to the other bf16 neighbour, the interval test flags
    them and few others (under 6%), and the recompute gives the plain
    version's every value."""
    x, ls, lb, w, b = _head_inputs(np.random.default_rng(48), 5000, 48, 48)
    ref = ln_head_ref(x, ls, lb, w, b)
    raw, _ = ln_head_class_schedule(x, ls, lb, w, b, recompute=False)
    got, share = ln_head_class_schedule(x, ls, lb, w, b)
    assert int((raw != ref).sum()) > 0
    assert torch.equal(got, ref)
    assert share < 0.06


def test_err_covers_the_two_orders_at_every_width():
    """The source header's derivation: the in-order f32 sum and KS
    tensor-core steps differ by at most (C - 1 + 35 KS) u |h| @ |W|, which
    ERR covers at every width; the templates' 4 C u would not at C = 8."""
    u = 2.0 ** -24
    for c in ALL:
        ks = _pad16(c) // 16
        assert head_err(c) >= (c - 1 + 35 * ks) * u
    assert 4 * 8 * u < (8 - 1 + 35) * u


def test_interval_flag_catches_what_can_flip():
    """A sum within err of a bf16 rounding midpoint is flagged, one half an
    ulp away is not, and a sum within err of zero (its neighbours' signs
    differ) is."""
    mid = torch.tensor([1.0 + 2.0 ** -8, -(3.0 + 2.0 ** -7)])
    mag = torch.full_like(mid, 4.0)
    near = torch.nextafter(mid, torch.zeros_like(mid))
    assert bool(flag_interval(mid, mag, 48).all()) and bool(flag_interval(near, mag, 48).all())
    assert not bool(flag_interval(torch.tensor([1.0, -3.0]), mag, 48).any())
    assert bool(flag_interval(torch.tensor([1e-9]), torch.tensor([4.0]), 48).all())


@pytest.mark.parametrize("c,n", [(48, 48), (256, 256), (16, 130)])
def test_f32_head_chunks_keep_the_order(c, n):
    """The f32 kernel's W chunks (all N where C x N f32 fit in 128 KB, else
    the most that do): each output's sum runs over all C in order inside
    one chunk, so the chunked head equals ``ln_head_ref`` bit for bit."""
    rng = np.random.default_rng(c + n)
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, ls, lb, w, b = f(70, c), f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, n) / c ** 0.5, f(n) * 0.1
    nc = f32_head_chunk(c, n)
    assert (nc >= n) == (c * n * 4 <= 131072)
    parts = [ln_head_ref(x, ls, lb, w[:, n0:n0 + nc], b[n0:n0 + nc]) for n0 in range(0, n, nc)]
    assert torch.equal(torch.cat(parts, dim=1), ln_head_ref(x, ls, lb, w, b))


@pytest.mark.parametrize("c", [24, 48, 256])
def test_f32_tail_blocks_cover_the_function(c):
    """The f32 kernel's schedule: 32-row blocks, 256-column hidden chunks
    (the last a multiple of 32), a thread 8 rows x 4 columns, the lanes of
    the warps 4-7 on the column quads past 128; each block's GEMM2 sums
    the chunks in order. Within the Pallas bound of the plain version
    (sums in another order)."""
    rng = np.random.default_rng(c)
    f = lambda *s: T(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    v = 70
    x, sc = f(v, c), f(v, c) * 0.1
    ls, lb, w1, b1 = f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, 4 * c) / c ** 0.5, f(4 * c) * 0.1
    w2, b2, g = f(4 * c, c) / (2 * c ** 0.5), f(c) * 0.1, torch.full((c,), 0.5)
    out = torch.full((v, c), float("nan"))
    quads = [((w >> 2) * 32 + lane) * 4 for w in range(8) for lane in range(32)]
    for r0 in range(0, v, 32):
        h = layer_norm_rows(x[r0:r0 + 32], ls, lb, torch.float32)
        acc2 = torch.zeros(h.shape[0], c)
        for j0 in range(0, 4 * c, 256):
            hc = min(256, 4 * c - j0)
            assert hc % 32 == 0
            a = torch.zeros(h.shape[0], hc)
            for q0 in sorted(set(quads)):
                if q0 < hc:
                    cols = slice(j0 + q0, j0 + q0 + 4)
                    a[:, q0:q0 + 4] = _gelu(h @ w1[:, cols] + b1[cols])
            for q0 in sorted(set(quads)):
                if q0 < c:
                    acc2[:, q0:q0 + 4] += a @ w2[j0:j0 + hc, q0:q0 + 4]
        out[r0:r0 + 32] = sc[r0:r0 + 32] + (acc2 + b2) * g
    ref = mlp_block_tail_ref(x, sc, ls, lb, w1, b1, w2, b2, g)
    torch.testing.assert_close(out, ref, atol=4e-3, rtol=1e-3)


# ---- against JAX ---------------------------------------------------------------


def _mlp_inputs(rng, v, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(v, c), f(v, c), f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, 4 * c) * 0.1, f(4 * c) * 0.1,
            f(4 * c, c) * 0.1, f(c) * 0.1, np.full(c, 0.9, np.float32))


@pytest.mark.parametrize("c", [48, 96, 192])
def test_tail_ref_matches_pallas_at_wide_widths(rng, c):
    """The wide model's widths, f32 (every rounding point the identity):
    the bound of ``tests/test_pallas_mlp.py`` (the Pallas kernel's A&S erf
    against the exact erf, sums in another order)."""
    args = _mlp_inputs(rng, 256, c)
    want = np.asarray(_mlp_call(*map(jnp.asarray, args), interpret=True))
    got = mlp_block_tail_ref(*map(T, args)).numpy()
    np.testing.assert_allclose(got, want, atol=4e-3, rtol=1e-3)


@pytest.mark.parametrize("c,n", [(48, 48), (96, 96), (192, 192), (48, 200)])
def test_ln_head_ref_matches_pallas_at_wide_widths(rng, c, n):
    """f32 throughout, sums in another order only: 1e-5."""
    x = rng.standard_normal((512, c)).astype(np.float32)
    ls = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    lb = (rng.standard_normal(c) * 0.1).astype(np.float32)
    w = (rng.standard_normal((c, n)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want = np.asarray(_ln_head_call(*map(jnp.asarray, (x, ls, lb, w, b)), interpret=True))
    got = ln_head_ref(*map(T, (x, ls, lb, w, b))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wide_model_matches_flax(rng):
    """The 1.5x-wide UNeXT3D the card's smoke drives (``MODEL.DIMS``
    48-96-192-96-48, 48 output channels), at depth 1 on a 16x16x8 volume,
    f32 in both packages with JAX's random weights carried across: within
    2e-5 (sums in other orders, as ``tests/test_torch_model.py``). Every
    block runs the fused tail's plain version and the head the fused LN
    head's, as JAX's model runs its kernels at these widths."""
    dims = (48, 96, 192, 96, 48)
    m = {"DIMS": list(dims), "DEPTHS": [1] * 5, "KERNEL_SIZE": 7, "OUT_CHANNELS": 48,
         "DTYPE": "float32"}
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
    x = rng.standard_normal((1, 16, 16, 8, 1)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        got = tm(T(x)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 8, 5)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
