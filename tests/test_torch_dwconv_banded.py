"""The bf16 depthwise conv kernel's tensor-core decomposition
(``skoots_tpu_torch/csrc/dwconv.cu::dwconv3d_tc_kernel``), stated in torch
and run at f32 on the CPU against the plain version (and, at one k = 7
shape, against the Pallas slab kernel in interpret mode); then the 32-channel
stem's implicit GEMM (``stem_gemm_kernel``) the same way.

The emulation indexes exactly as the kernel does:

- the launcher's split of X into ranges of ``xt`` planes (the grid covers
  the SMs about twice), each range streaming its input planes
  ``xs - k/2 ... xe - 1 + k/2`` (zero outside the volume);
- a block's output is 16 y x 8 z of 8 channels; its staged input window
  starts at ``(y0 - k/2, z0 - k/2)``: rows ``y0 - k/2 + r`` for
  ``r < 16 + k - 1``, 16 window columns ``z0 - k/2 + s``, zero outside the
  volume (the masks on ragged Y and Z);
- for each (dx, dy) the z taps are a 16 x 8 banded matrix
  ``T[i, j] = w[dx, dy, i - j]`` (``0 <= i - j < k``), and
  ``D[16 y, 8 z] += A[16 y, 16 z window] @ T`` with A the window rows
  ``dy ... dy + 15`` (one ``m16n8k16``);
- input plane ``xi`` (step ``t`` of the range) adds into the k output
  planes ``xi + k/2 - dx``, held in a ring of k accumulators, slot
  ``(t - dx) mod k``; after step ``t`` slot ``(t + 1) mod k`` is output
  plane ``xi - k/2``: bias added, stored where it lies inside the range,
  then zeroed. Planes outside the range take sums that are never stored.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.dwconv import dwconv3d_pallas
from skoots_tpu_torch.kernels.dwconv import dwconv3d_ref

H100_SMS = 132
YT, ZT, ZW = 16, 8, 16  # block rows (mma M), outputs along z (N), window (K)


def x_split(bsz, xs, ys, zs, c, sms=H100_SMS):
    """The launcher's (ranges, planes a range) for X."""
    base = bsz * -(-ys // YT) * -(-zs // ZT) * (c // 8)
    nxs = min(max(-(-2 * sms // base), 1), -(-xs // 8))
    xt = -(-xs // nxs)
    return -(-xs // xt), xt


def banded_taps(w: torch.Tensor) -> torch.Tensor:
    """``[k, k, 16, 8, C]``: T[dx, dy, i, j] = w[dx, dy, i - j] on the band."""
    k = w.shape[0]
    dz = torch.arange(ZW)[:, None] - torch.arange(ZT)[None]
    band = (dz >= 0) & (dz < k)
    return w[:, :, dz.clamp(0, k - 1)] * band[..., None]


def staged_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, X, nyb, 16 + k - 1, nzb, 16, Cin]``: every block's staged
    window of every x plane, zero outside the volume."""
    _, _, ys, zs, _ = x.shape
    p = k // 2
    gy = torch.arange(-(-ys // YT))[:, None] * YT - p + torch.arange(YT + k - 1)
    gz = torch.arange(-(-zs // ZT))[:, None] * ZT - p + torch.arange(ZW)
    mask = ((gy >= 0) & (gy < ys))[:, :, None, None] & ((gz >= 0) & (gz < zs))[None, None]
    s = x.float()[:, :, gy.clamp(0, ys - 1)][:, :, :, :, gz.clamp(0, zs - 1)]
    return s * mask[..., None]


def dwconv_tc_emulated(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's schedule at f32 (x ``[B, X, Y, Z, C]``)."""
    bsz, xs_, ys, zs, _ = x.shape
    k, c = w.shape[0], w.shape[-1]
    p = k // 2
    taps = banded_taps(w.float())
    win = staged_windows(x, k)
    nyb, nzb = win.shape[2], win.shape[4]
    out = torch.full((bsz, xs_, nyb * YT, nzb * ZT, c), float("nan"))
    nxs, xt = x_split(bsz, xs_, ys, zs, c)
    for r in range(nxs):
        lo, hi = r * xt, min(xs_, r * xt + xt)
        acc = [torch.zeros(bsz, nyb, YT, nzb, ZT, c) for _ in range(k)]
        for t in range(hi - lo + k - 1):
            xi = lo - p + t
            if 0 <= xi < xs_:
                for dy in range(k):
                    a = win[:, xi, :, dy:dy + YT]  # [B, nyb, 16 y, nzb, 16 window, C]
                    for dx in range(k):
                        s = (t - dx) % k
                        acc[s] = acc[s] + torch.einsum("bnyzic,ijc->bnyzjc", a, taps[dx, dy])
            xo, s = xi - p, (t + 1) % k
            if xo >= lo:
                out[:, xo] = (acc[s] + b.float()).reshape(bsz, nyb * YT, nzb * ZT, c)
            acc[s] = torch.zeros_like(acc[s])
    return out[:, :, :ys, :zs]


def _inputs(rng, shape, cin, c, k):
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, c)) / k ** 1.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)


Z_CASES = [5, 8, 10, 20, 24]  # Z of the paths' levels: main 24; host 20, 10, 5; training 8


@pytest.mark.parametrize("z", Z_CASES)
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_banded_decomposition_matches_plain_version(rng, k, c, z):
    """Batch 2, X = 9 (split into two ranges), Y = 18 (a ragged second
    y block), the given Z (ragged z blocks at 5, 10, 20)."""
    x, w, b = _inputs(rng, (2, 9, 18, z), c, c, k)
    got = dwconv_tc_emulated(x, w, b)
    want = dwconv3d_ref(x, w, b)
    # f32 sums of the same k^3 products in another order
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_banded_decomposition_matches_pallas(rng):
    """k = 7, [1, 8, 8, 16, 32]: the emulation against the TPU slab kernel
    run as the JAX package's tests run it (interpret mode)."""
    x, w, b = _inputs(rng, (1, 8, 8, 16), 32, 32, 7)
    want = np.asarray(dwconv3d_pallas(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                      jnp.asarray(b.numpy()), block=(8, 8), interpret=True))
    got = dwconv_tc_emulated(x, w, b).numpy()
    # f32 sums in another order: 1e-3 as the JAX package's own tests
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_x_split_covers_the_grid():
    """One range where the grid already covers the card twice, ranges of
    at least 8 planes otherwise (the bench tile's, the host engine's and
    the training crop's levels)."""
    assert x_split(1, 256, 256, 96, 32) == (1, 256)
    assert x_split(1, 64, 64, 24, 128) == (2, 32)
    assert x_split(1, 256, 256, 20, 32) == (2, 128)
    assert x_split(1, 96, 96, 32, 32) == (3, 32)
    assert x_split(1, 24, 24, 8, 128) == (3, 8)


def stem_gemm_emulated(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``stem_gemm_kernel``'s GEMM at f32: x ``[B, X, Y, Z, 1]``, tiles of 8 y
    rows x 16 z; A[voxel, 8 group + dz] = the input at (x + dx, y + dy,
    z + dz) - k/2 for group = k dx + dy and dz < 8 (zero outside the
    volume), B[8 group + dz, c] = w[dx, dy, dz, c] (0 for dz >= k and for
    the padding group), k-steps of 16 = two groups."""
    bsz, xs_, ys, zs, _ = x.shape
    k, c = w.shape[0], w.shape[-1]
    p = k // 2
    yp, zp = -(-ys // 8) * 8, -(-zs // 16) * 16
    kp = 16 * ((k * k + 1) // 2)
    wk = torch.zeros(kp, c)
    for grp in range(k * k):
        wk[8 * grp:8 * grp + k] = w[grp // k, grp % k].float()
    xpad = torch.zeros(bsz, xs_ + 2 * p, yp + 2 * p, zp + 8 + p)
    xpad[:, p:p + xs_, p:p + ys, p:p + zs] = x[..., 0].float()
    cols = torch.zeros(bsz, xs_, yp, zp, kp)
    for grp in range(k * k):
        dx, dy = divmod(grp, k)
        for dz in range(8):
            cols[..., 8 * grp + dz] = xpad[:, dx:dx + xs_, dy:dy + yp, dz:dz + zp]
    out = cols @ wk + b.float()
    return out[:, :, :ys, :zs]


@pytest.mark.parametrize("z", Z_CASES)
@pytest.mark.parametrize("k", [3, 5, 7])
def test_stem_gemm_matches_plain_version(rng, k, z):
    """Batch 2, X = 5, Y = 11 (a ragged y tile), the given Z (tiles of 16
    z: every Z here leaves a ragged last tile)."""
    x, w, b = _inputs(rng, (2, 5, 11, z), 1, 32, k)
    torch.testing.assert_close(stem_gemm_emulated(x, w, b), dwconv3d_ref(x, w, b),
                               atol=2e-5, rtol=1e-5)
