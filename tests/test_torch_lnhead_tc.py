"""The bf16 LN head kernel's order of work
(``skoots_tpu_torch/csrc/lnhead.cu::ln_head_tc_kernel``), stated in torch
and run on the CPU against the plain version and, at a V that JAX's
``_pick_tile`` accepts, against the Pallas kernel in interpret mode.

The emulation follows the kernel:

- rows in warp tiles of 32, multiplied in 16-row halves; a partial last
  tile is padded with zero rows (cp.async's zero fill), which are
  normalised and multiplied like the others and never stored;
- the LayerNorm is the plain version's, bit for bit (``layer_norm_row``: a
  lane a row, ``warp_layer_norm_any``'s fold tree in one thread), rounded to
  bf16, with the LN scale and bias rounded to bf16 first;
- W is padded with zero columns to whole n16 groups of the ``8 NT``
  columns (``NT`` the n8 tiles: 1, 2, 4, 8 or 16);
- ``h @ W`` and ``|h| @ |W|`` accumulate in f32 one k16 chunk at a time
  (one ``mma.sync`` m16n8k16 a chunk and n8 tile: the bf16 products are
  exact; here a chunk's sum is taken in f64 and rounded once, a model of
  the tensor cores' order that no BLAS summation order changes);
- a sum with a bf16 rounding midpoint within ``4 C 2^-24 |h| @ |W|`` of it,
  or zero within 1024 times that, is flagged and recomputed in the
  plain version's order (products added for k = 0, 1, ...);
- round to bf16, add the bf16 bias in f32, round again; store the first N
  columns of the valid rows.

So the kernel equals ``ln_head_ref`` bit for bit. Without the recompute a
sum whose rounding flips moves its output by a bf16 ulp of the sum, two of
an output whose bias add crossed into a lower binade: the tensor cores'
order broke the 1-ulp bound on the card, and
``test_recompute_repairs_the_flipped_roundings`` shows such flips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.lnhead import _ln_head_call
from skoots_tpu.kernels.mlp import _pick_tile
from skoots_tpu_torch.kernels.lnhead import ln_head_ref
from skoots_tpu_torch.kernels.mlp import layer_norm_rows

BF = torch.bfloat16


def n_tiles(n: int) -> int:
    """The launcher's n8 tiles for N outputs (``dispatch_n``)."""
    return next(t for t in (1, 2, 4, 8, 16) if n <= 8 * t)


def flag(acc: torch.Tensor, mag: torch.Tensor, c: int) -> torch.Tensor:
    """The sums the kernel recomputes in order."""
    err = 4.0 * c / 2 ** 24 * mag
    bits = acc.view(torch.int32)
    mid = ((bits & -65536) | 0x8000).view(torch.float32)
    return ((acc - mid).abs() <= err) | (acc.abs() <= 1024.0 * err)


def ln_head_tc(x, ln_scale, ln_bias, w, b, recompute=True):
    """The kernel's output for bf16 ``x`` ``[V, C]``, ``w`` ``[C, N]``; also
    the share of the stored sums it recomputed (``recompute=False``: the
    tensor cores' sums as they are)."""
    v, c = x.shape
    n = w.shape[1]
    rows = -(-v // 32) * 32
    xp = torch.cat([x, torch.zeros((rows - v, c), dtype=x.dtype)])
    h = layer_norm_rows(xp, ln_scale.to(BF).float(), ln_bias.to(BF).float(), BF)
    cols = -(-n_tiles(n) // 2) * 16
    wp = torch.zeros((c, cols))
    wp[:, :n] = w.to(BF).float()
    bp = torch.zeros(cols)
    bp[:n] = b.to(BF).float()
    acc = torch.zeros((rows, cols))
    mag = torch.zeros((rows, cols))
    hd, wd = h.double(), wp.double()
    for k0 in range(0, c, 16):
        acc = acc + (hd[:, k0:k0 + 16] @ wd[k0:k0 + 16]).float()
        mag = mag + (hd[:, k0:k0 + 16].abs() @ wd[k0:k0 + 16].abs()).float()
    redo = flag(acc, mag, c) & recompute
    redo[v:] = False
    redo[:, n:] = False
    rr, cc = redo.nonzero(as_tuple=True)
    in_order = h[rr, 0] * wp[0, cc]
    for k in range(1, c):
        in_order = in_order + h[rr, k] * wp[k, cc]
    acc[rr, cc] = in_order
    y = (acc.to(BF).float() + bp).to(BF)
    return y[:v, :n], float(redo.sum()) / (v * n)


def bf16_ulps(got, ref) -> float:
    r = ref.float().abs()
    scale = torch.maximum(r, r.square().mean().sqrt())
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale)[1] - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def _inputs(rng, v, c, n):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(v, c), f(c) * 0.1 + 1.0, f(c) * 0.1, f(c, n) / np.sqrt(c), f(n) * 0.1)


@pytest.mark.parametrize("n", [8, 32, 5])
@pytest.mark.parametrize("c", [32, 64, 128])
def test_tc_schedule_equals_plain_version(c, n):
    """At a V with a partial 16-row tile; the recomputed share stays small
    (the kernel's cost rests on it), growing with C as the bound does (5%
    at C = 32)."""
    x, ls, lb, w, b = map(torch.from_numpy, _inputs(np.random.default_rng(c + n), 16 * 40 + 7,
                                                    c, n))
    x, w = x.to(BF), w.to(BF)
    got, share = ln_head_tc(x, ls, lb, w, b)
    ref = ln_head_ref(x, ls, lb, w, b)
    assert got.dtype == BF and got.shape == ref.shape
    assert torch.equal(got, ref)
    assert share < c / 320


def test_recompute_repairs_the_flipped_roundings():
    """At the main path's C = N = 32 over 640,000 sums, the chunked order
    rounds some sums to the other bf16 neighbour (as the card's tensor cores
    did); the flagged recompute gives the plain version's every value."""
    x, ls, lb, w, b = map(torch.from_numpy, _inputs(np.random.default_rng(7), 20000, 32, 32))
    x, w = x.to(BF), w.to(BF)
    ref = ln_head_ref(x, ls, lb, w, b)
    raw, _ = ln_head_tc(x, ls, lb, w, b, recompute=False)
    got, _ = ln_head_tc(x, ls, lb, w, b)
    assert int((raw != ref).sum()) > 0
    assert torch.equal(got, ref)


def test_flag_catches_midpoints_and_zero():
    """A sum on a bf16 rounding midpoint, or one f32 ulp beside it, is
    flagged; one half a bf16 ulp away is not; a tiny sum is."""
    mid = torch.tensor([1.0 + 2.0 ** -8, -(3.0 + 2.0 ** -7)])
    mag = torch.full_like(mid, 4.0)
    near = torch.nextafter(mid, torch.zeros_like(mid))
    far = torch.tensor([1.0, -3.0])
    assert bool(flag(mid, mag, 32).all()) and bool(flag(near, mag, 32).all())
    assert not bool(flag(far, mag, 32).any())
    assert bool(flag(torch.tensor([1e-4]), torch.tensor([4.0]), 32).all())


def test_tc_schedule_within_one_ulp_of_pallas_interpret():
    """V = 512 (a tile ``_pick_tile`` accepts), C = N = 32: the Pallas
    kernel run as its own tests run it, on the same bf16 inputs, the LN
    scale and bias as bf16 values (the model passes them so; the port's
    versions round them to the model dtype)."""
    v, c, n = 512, 32, 32
    assert _pick_tile(v, c) is not None
    x, ls, lb, w, b = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                       for a in _inputs(np.random.default_rng(23), v, c, n))
    xj, wj, bj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))
    want = np.array(_ln_head_call(xj, jnp.asarray(ls), jnp.asarray(lb), wj, bj,
                                  interpret=True).astype(jnp.float32))
    got, _ = ln_head_tc(torch.from_numpy(x).to(BF), torch.from_numpy(ls), torch.from_numpy(lb),
                        torch.from_numpy(w).to(BF), torch.from_numpy(b))
    assert bf16_ulps(got, torch.from_numpy(want)) <= 1.0
