"""The upsample kernel's z-march (``skoots_tpu_torch/csrc/upsample.cu``),
stated in torch and run on the CPU against the plain version bit for bit
(bf16 and f32), and at one shape of ``tests/test_pallas_upsample.py``
against the Pallas kernel in interpret mode.

The emulation follows the kernel's schedule:

- a thread owns a vector of ``v`` channels (8 bf16 = 16 bytes; 1 where C
  allows no wider vector) of one (b, i, j) column; every channel vector is
  computed on its own;
- it marches over a segment ``[k0, k1)`` of ``s`` input planes along z,
  starting by re-reading the plane below (the first segment: plane 0, the
  edge clamp);
- plane k gives ``P_k``: the x then y blends of its clamped 3x3 (x, y)
  neighbourhood at the four outputs (2i + a, 2j + q);
- with ``P_{k-1}`` held from the step before, it writes output plane
  ``2k - 1`` (where k > 0) and ``2k``; the last segment also writes
  ``2Z - 1``, its neighbour clamped to itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.upsample import _pick_blocks, _upsample2x_call
from skoots_tpu_torch.kernels.upsample import SEGMENT_PLANES, upsample2x_ref


def blend(centre: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """0.75 centre + 0.25 neighbour in f32, each step rounded on its own."""
    return 0.75 * centre + 0.25 * nbr


def march(x: torch.Tensor, s: int, v: int):
    """The kernel's output for ``x`` ``[B, X, Y, Z, C]`` at segment length
    ``s`` and vector width ``v``; also the input planes read."""
    bsz, xs, ys, zs, c = x.shape
    assert c % v == 0
    xf = x.float()
    out = torch.full((bsz, 2 * xs, 2 * ys, 2 * zs, c), float("nan"), dtype=x.dtype)
    ix = torch.arange(xs)
    iy = torch.arange(ys)
    nx = ((ix - 1).clamp(0, xs - 1), ix, (ix + 1).clamp(0, xs - 1))
    ny = ((iy - 1).clamp(0, ys - 1), iy, (iy + 1).clamp(0, ys - 1))
    reads = 0

    def plane(k, cs):
        """P_k: [a][q] -> [B, X, Y, v]."""
        nonlocal reads
        reads += 1
        p = xf[:, :, :, k, cs]
        val = [[p[:, nx[a]][:, :, ny[q]] for q in range(3)] for a in range(3)]
        t1 = [[blend(val[1][q], val[0][q]) for q in range(3)],
              [blend(val[1][q], val[2][q]) for q in range(3)]]
        return [[blend(t1[a][1], t1[a][0]), blend(t1[a][1], t1[a][2])] for a in range(2)]

    def emit(z, ctr, nbr, cs):
        for a in range(2):
            for q in range(2):
                out[:, a::2, q::2, z, cs] = blend(ctr[a][q], nbr[a][q]).to(x.dtype)

    for c0 in range(0, c, v):
        cs = slice(c0, c0 + v)
        for k0 in range(0, zs, s):
            k1 = min(k0 + s, zs)
            prev = plane(max(k0 - 1, 0), cs)
            for k in range(k0, k1):
                cur = plane(k, cs)
                if k > 0:
                    emit(2 * k - 1, prev, cur, cs)
                emit(2 * k, cur, prev, cs)
                prev = cur
            if k1 == zs:
                emit(2 * zs - 1, prev, prev, cs)
    return out, reads


# ragged z for the package's segment (Z = 1, 2, S - 1, S + 1, several
# segments), X = Y = 1, and C = 3 (vector width 1)
S = SEGMENT_PLANES
CASES = [
    ((1, 3, 2, 1, 8), 8), ((2, 1, 1, 2, 16), 8), ((1, 4, 3, S - 1, 8), 8),
    ((1, 3, 5, S + 1, 16), 8), ((2, 2, 3, 2 * S + 3, 8), 1), ((1, 2, 3, S + 1, 3), 1),
    ((1, 1, 1, 5, 3), 1),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,v", CASES, ids=[f"{c[0]}-v{c[1]}" for c in CASES])
def test_march_matches_plain_version(shape, v, dtype):
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(shape).astype(np.float32))
    x = x.to(dtype)
    want = upsample2x_ref(x)
    for s in (S, 3):
        got, reads = march(x, s, v)
        assert torch.equal(got, want), (shape, v, s)
        # each segment reads its planes and the one below its start
        segments = -(-shape[3] // s)
        assert reads == (shape[4] // v) * (shape[3] + segments)


def test_march_matches_pallas_interpret():
    """One shape of ``tests/test_pallas_upsample.py`` (its z-blocked path)
    at that file's tolerance: the Pallas kernel blends z first, the march
    x first."""
    shape = (1, 16, 16, 24, 16)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    bx, by, bz = _pick_blocks(*shape[1:], 4)
    want = np.asarray(_upsample2x_call(jnp.asarray(x[0]), bx, by, bz, interpret=True))
    got, _ = march(torch.from_numpy(x), S, 8)
    np.testing.assert_allclose(got[0].numpy(), want, atol=2e-6)
