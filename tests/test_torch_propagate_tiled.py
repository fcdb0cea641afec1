"""The propagate kernel's tiled schedule (``skoots_tpu_torch/csrc/propagate.cu``)
stated in torch and run on the CPU against ``propagate_ref`` applied
``passes`` times and against the Pallas kernel it replaces
(``propagate_pallas(..., interpret=True)``), exactly.

The emulation indexes as the kernel does:

- the wrapper runs :func:`launch_plan`'s launches (``QMAX``-pass launches,
  then one remainder) over two buffers zeroed once a call, the first
  launch reading the caller's labels;
- a launch covers the volume with tiles of ``TX x TY x TZ`` interior
  (``TZ = 32 VZ - 2 QMAX``), each loaded with a ``QMAX``-voxel halo on
  every side, labels and foreground zero outside the volume;
- the tiles whose interior holds foreground are listed once a call (the
  helper kernel); a launch visits only those, so a tile without is never
  read or written, and the zeroed buffer already holds its output;
- each listed tile runs ``q`` passes on its halo tile, each masking the
  whole halo tile by its foreground. A voxel on a face of the halo tile
  takes, in place of its outside neighbour, the value the kernel's
  registers, lanes and rows give it: its own along x and y, and along z
  the lane's other end (its own at ``VZ = 1``);
- only the interior inside the volume is written back.

The volumes are ragged against every tile shape, hold tiles with no
foreground, labels that are non-zero at background, a two-voxel diagonal
tube through the tiles' corners (its labels cross tile corners
diagonally) and straight lines along each axis (6-connected labels cross
faces only there): a halo one voxel short of the passes fails on them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from propagate_cases import PASSES, corner_tube_case, plain

from skoots_tpu.kernels.propagate import propagate_pallas
from skoots_tpu_torch.kernels.propagate import QMAX, launch_plan, propagate
from skoots_tpu_torch.tools.bench_propagate import default_tile

# the kernel's own tile, and two others (QMAX 4 and 3, the latter at VZ 2):
# the schedule holds for any (QMAX, TX, TY, VZ)
TILES = [default_tile(), (4, 16, 8, 1), (3, 8, 4, 2)]


def _max3(a: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """max(a[i - 1], a[i], a[i + 1]) along ``axis``, the face voxels taking
    ``a[lo]`` / ``a[hi]`` for their outside neighbour."""
    n = a.shape[axis]
    idx = torch.arange(-1, n + 1).clamp(0, n - 1)
    idx[0], idx[-1] = lo, hi
    p = a.index_select(axis, idx)
    return torch.maximum(torch.maximum(p.narrow(axis, 0, n), p.narrow(axis, 2, n)),
                         p.narrow(axis, 1, n))


def _faces(a: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """max(a[i - 1], a[i + 1]) along ``axis``, faces as in :func:`_max3`."""
    n = a.shape[axis]
    idx = torch.arange(-1, n + 1).clamp(0, n - 1)
    idx[0], idx[-1] = lo, hi
    p = a.index_select(axis, idx)
    return torch.maximum(p.narrow(axis, 0, n), p.narrow(axis, 2, n))


def tile_pass(s: torch.Tensor, f: torch.Tensor, vz: int, conn: int) -> torch.Tensor:
    """One pass on a halo tile ``[SX, SY, SZ]`` as the kernel computes it:
    26-conn x, then z, then y maxima; 6-conn self and faces; then the mask."""
    sx, sy, sz = s.shape
    zlo, zhi = vz - 1, sz - vz
    if conn == 26:
        t = _max3(_max3(_max3(s, 0, 0, sx - 1), 2, zlo, zhi), 1, 0, sy - 1)
    else:
        t = torch.maximum(torch.maximum(s, _faces(s, 0, 0, sx - 1)),
                          torch.maximum(_faces(s, 2, zlo, zhi), _faces(s, 1, 0, sy - 1)))
    return torch.where(f > 0, t, 0)


def interior(tile) -> tuple:
    qmax, tx, ty, vz = tile
    return tx, ty, 32 * vz - 2 * qmax


def emulated_tile_list(fg, tile) -> list:
    """The helper kernel: the origins of the tiles (in tile order) whose
    interior holds foreground."""
    tx, ty, tz = interior(tile)
    xs, ys, zs = fg.shape
    return [(x0, y0, z0) for x0 in range(0, xs, tx) for y0 in range(0, ys, ty)
            for z0 in range(0, zs, tz) if bool(fg[x0:x0 + tx, y0:y0 + ty, z0:z0 + tz].any())]


def emulated_launch(src, fg, dst, tiles, q, tile, conn) -> None:
    """One kernel launch over the listed tiles: ``q`` passes from ``src``
    into ``dst``."""
    qmax, vz = tile[0], tile[3]
    tx, ty, tz = interior(tile)
    # zero outside the volume, and far enough past it for a full halo tile
    pad = (qmax, qmax + tz, qmax, qmax + ty, qmax, qmax + tx)
    srcp = torch.nn.functional.pad(src, pad)
    fgp = torch.nn.functional.pad(fg, pad)
    for x0, y0, z0 in tiles:
        win = (slice(x0, x0 + tx + 2 * qmax), slice(y0, y0 + ty + 2 * qmax),
               slice(z0, z0 + tz + 2 * qmax))
        s, f = srcp[win], fgp[win]
        for _ in range(q):
            s = tile_pass(s, f, vz, conn)
        inner = s[qmax:qmax + tx, qmax:qmax + ty, qmax:qmax + tz]
        ex, ey, ez = dst[x0:x0 + tx, y0:y0 + ty, z0:z0 + tz].shape
        dst[x0:x0 + ex, y0:y0 + ey, z0:z0 + ez] = inner[:ex, :ey, :ez]


def emulated_propagate(labels, fg, passes, tile, conn):
    """The wrapper: the tile list, then the launch plan over two buffers
    zeroed once a call."""
    plan = launch_plan(passes, tile[0])
    tiles = emulated_tile_list(fg, tile)
    bufs = [torch.zeros_like(labels) for _ in range(min(len(plan), 2))]
    src = labels
    for i, q in enumerate(plan):
        emulated_launch(src, fg, bufs[i % 2], tiles, q, tile, conn)
        src = bufs[i % 2]
    return src


def test_wrapper_plans_the_sources_qmax():
    assert QMAX == default_tile()[0]


@pytest.mark.parametrize("qmax", [1, 2, 4, 8])
@pytest.mark.parametrize("passes", [0, 1, 3, 4, 5, 8, 11, 192])
def test_launch_plan(passes, qmax):
    plan = launch_plan(passes, qmax)
    assert sum(plan) == passes and all(1 <= q <= qmax for q in plan)
    assert len(plan) == -(-passes // qmax)
    assert plan[:-1] == [qmax] * (len(plan) - 1)


@pytest.mark.parametrize("conn", [26, 6])
@pytest.mark.parametrize("tile", TILES, ids=[f"q{t[0]}-{t[1]}x{t[2]}-vz{t[3]}" for t in TILES])
def test_tiled_schedule_matches_plain_passes(tile, conn):
    """Every pass count of PASSES, on two ragged volumes, the second with
    labels at the background; exact."""
    qmax = tile[0]
    passes_list = [1, 3, qmax, qmax + 1, 2 * qmax + 3]
    for shape, background in (((37, 21, 53), False), ((19, 30, 70), True)):
        lab, fg = corner_tube_case(shape, tile, seed=sum(shape), background_labels=background)
        for passes in passes_list:
            got = emulated_propagate(lab, fg, passes, tile, conn)
            assert torch.equal(got, plain(lab, fg, passes, conn)), (shape, passes)
            assert got is not lab


@pytest.mark.parametrize("conn", [26, 6])
@pytest.mark.parametrize("passes", PASSES)
def test_tiled_schedule_matches_pallas(passes, conn):
    """The kernel's own tile against the Pallas kernel in interpret mode
    (X a multiple of its block_x = 8) and the port's CPU wrapper; exact."""
    tile = TILES[0]
    lab, fg = corner_tube_case((40, 21, 53), tile, seed=passes, background_labels=True)
    want = np.asarray(propagate_pallas(jnp.asarray(lab.numpy()), jnp.asarray(fg.numpy()),
                                       passes=passes, connectivity=conn, block_x=8,
                                       interpret=True))
    got = emulated_propagate(lab, fg, passes, tile, conn)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(propagate(lab, fg, passes, conn).numpy(), want)


def test_skipped_tiles_are_zero_in_both_buffers():
    """A tile without foreground in its interior keeps the zeros of the
    wrapper's buffers through every launch, though the caller's labels
    there are not zero and foreground lies in its halo."""
    tile = TILES[0]
    qmax, tx, ty, vz = tile
    shape = (3 * tx, 2 * ty, 32 * vz - 2 * qmax)
    lab = torch.full(shape, 7, dtype=torch.int32)
    fg = torch.zeros(shape, dtype=torch.uint8)
    fg[tx - 1, :, :] = 1  # the last plane of tile 0, in tile 1's halo
    got = emulated_propagate(lab, fg, 2 * qmax + 3, tile, 26)
    assert torch.equal(got, plain(lab, fg, 2 * qmax + 3, 26))
    assert not bool(got[tx:].any()) and bool(got[tx - 1].all())
