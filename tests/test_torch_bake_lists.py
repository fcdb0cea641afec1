"""The skeleton bake's own-instance lists (``skoots_tpu_torch/csrc/bake.cu``),
stated in torch and held bit for bit against the plain version, and
against the TPU kernel (``bake_skeleton_pallas``, interpret mode) on the
CPU.

The kernel indexes as follows:

- a block covers a 1 x 16 x 16 voxel tile (thread ``(tid / 16, tid % 16)``
  the voxel at (y, z) of its x plane) and lists the tile's distinct
  foreground ids, ascending; a tile without foreground writes zeros;
- with at most ``CAP`` ids it counts each id's points, places them, a chunk
  of 256 at a time, at ``cursor[id] + (same-id points of earlier warps) +
  (same-id points of earlier lanes)`` -- each id's list in the points'
  original order -- and each voxel runs a strict-< minimum over its own
  id's list; the coordinates of the best index are read at the end;
- with more ids, or more listed points than the ``lcap`` the block holds,
  it scans every point with the id compare.

Both branches keep the FIRST minimal point in the original order, as the
plain version's ``argmin`` does, with the same rounded d2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.kernels.bake import bake_skeleton_pallas
from skoots_tpu_torch.kernels.bake import BIG, bake_skeleton_kernel, bake_skeleton_ref

TX, TY, TZ = 1, 16, 16  # the tile: one x plane, a thread a voxel
THREADS, WARP = 256, 32
CAP, LMAX = 8, 4096
ANISO = (1.0, 1.0, 3.0)
SHAPE = (12, 20, 18)  # ragged against the tile in every axis


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def list_capacity(p: int, lmax: int = LMAX) -> int:
    """Points a block's shared list holds: all P when it can, at least a
    chunk of 256."""
    return THREADS if p < THREADS else (-(-p // 32) * 32 if p < lmax else lmax)


def place(ids: torch.Tensor, tile_ids: list) -> torch.Tensor:
    """The kernel's placement: the list index of every point (-1 where its
    id is not listed), chunk by chunk, warp by warp, lane by lane."""
    slot = torch.full_like(ids, -1)
    for s, i in enumerate(tile_ids):
        slot[ids == i] = s
    counts = torch.bincount(slot[slot >= 0], minlength=len(tile_ids))
    cursor = torch.cumsum(counts, 0) - counts  # each id's start
    where = torch.full_like(ids, -1)
    for p0 in range(0, len(ids), THREADS):
        chunk = slot[p0:p0 + THREADS]
        # each warp's ballot popcount per id
        warp_counts = torch.zeros(THREADS // WARP, len(tile_ids), dtype=torch.long)
        for t, s in enumerate(chunk.tolist()):
            if s >= 0:
                warp_counts[t // WARP, s] += 1
        for t, s in enumerate(chunk.tolist()):
            if s >= 0:
                w, lane = divmod(t, WARP)
                rank = int((chunk[w * WARP:w * WARP + lane] == s).sum())  # earlier lanes
                where[p0 + t] = cursor[s] + warp_counts[:w, s].sum() + rank
        cursor = cursor + warp_counts.sum(0)
    return where


def d2_of(v: torch.Tensor, pts: torch.Tensor, aniso) -> torch.Tensor:
    """``[V, L]``: the rounded d2 of the kernel, one op at a time."""
    d = v[:, None, :] - pts[None]
    return (d[..., 0] * d[..., 0] * aniso[0] + d[..., 1] * d[..., 1] * aniso[1]
            + d[..., 2] * d[..., 2] * aniso[2])


def first_min(d2: torch.Tensor):
    """A strict-< running minimum in list order: the first minimal index."""
    best = torch.argmin(d2, dim=1)
    return best, torch.gather(d2, 1, best[:, None])[:, 0]


def bake_lists_emulated(masks, points, ids, aniso=ANISO, lmax=LMAX):
    """The kernel at f32 on the CPU: ``masks`` ``[X, Y, Z]`` int32,
    ``points`` ``[P, 3]`` f32, ``ids`` ``[P]`` int32. Returns (baked, dist,
    the branch each tile took)."""
    xs, ys, zs = masks.shape
    lcap = list_capacity(len(ids), lmax)
    baked = torch.zeros(xs, ys, zs, 3)
    dist = torch.zeros(xs, ys, zs)
    branches = []
    for x0 in range(0, xs, TX):
        for y0 in range(0, ys, TY):
            for z0 in range(0, zs, TZ):
                tile = (slice(x0, x0 + TX), slice(y0, y0 + TY), slice(z0, z0 + TZ))
                m = masks[tile]
                tile_ids = sorted(set(m[m != 0].tolist()))
                if not tile_ids:
                    branches.append("background")
                    continue
                grid = torch.stack(torch.meshgrid(
                    *[torch.arange(s.start, s.start + n, dtype=torch.float32)
                      for s, n in zip(tile, m.shape)], indexing="ij"), -1)
                where = place(ids, tile_ids) if len(tile_ids) <= CAP else None
                listed = where is not None and int((where >= 0).sum()) <= lcap
                branches.append("listed" if listed else "full scan")
                tb, td = torch.zeros(*m.shape, 3), torch.zeros(m.shape)
                for i in tile_ids:
                    vox = m == i
                    if listed:  # the id's list, in list order: no id compare
                        order = torch.argsort(torch.where(where >= 0, where, 1 << 30))
                        own = order[ids[order] == i]
                        pts = points[own]
                        d2 = d2_of(grid[vox], pts, aniso)
                    else:  # every point, non-matching ones never taken
                        pts = points
                        d2 = torch.where(ids[None] == i, d2_of(grid[vox], pts, aniso),
                                         torch.full((1, 1), float("inf")))
                    if pts.shape[0] == 0:
                        continue
                    best, mind2 = first_min(d2)
                    found = mind2 < BIG
                    tb[vox] = torch.where(found[:, None], pts[best], 0.0)
                    td[vox] = torch.where(found, torch.sqrt(mind2.clamp_min(0.0)), 0.0)
                baked[tile] = tb
                dist[tile] = td
    return baked, dist, branches


def test_placement_is_a_stable_compaction():
    """700 points (three chunks) of 6 ids and padding, 4 of them listed:
    each listed id's points land contiguously, in their original order,
    ids in list order."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 7, 700).astype(np.int32))
    listed = [2, 3, 5, 6]
    where = place(ids, listed)
    keep = torch.isin(ids, torch.tensor(listed, dtype=torch.int32))
    assert bool((where[~keep] == -1).all())
    slot = torch.tensor([listed.index(i) if i in listed else 99 for i in ids.tolist()])
    stable = torch.argsort(slot * 10_000 + torch.arange(700))[:int(keep.sum())]
    n = int(keep.sum())
    assert torch.equal(torch.sort(where[keep]).values, torch.arange(n))  # dense, no gaps
    assert torch.equal(torch.nonzero(keep)[:, 0][torch.argsort(where[keep])], stable)


def _boxes(rng, shape, n):
    masks = np.zeros(shape, np.int32)
    boxes = []
    for i in range(1, n + 1):
        lo = rng.integers(0, np.asarray(shape) // 2)
        hi = np.minimum(lo + rng.integers(3, np.asarray(shape) // 2 + 3), shape)
        masks[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = i
        boxes.append((lo, hi))
    return masks, boxes


def _in_boxes(rng, boxes, ids):
    lo = np.stack([boxes[i - 1][0] for i in np.maximum(ids, 1)])
    hi = np.stack([boxes[i - 1][1] for i in np.maximum(ids, 1)])
    return (lo + rng.random((len(ids), 3)) * (hi - lo)).astype(np.float32)


def case(name: str):
    """(masks, points, ids) of each case, seeded."""
    rng = np.random.default_rng(7)
    if name == "duplicates":
        # integer points, each repeated later, and mirrored copies two
        # voxels away in x: many voxels see two or three points at one d2
        masks, boxes = _boxes(rng, SHAPE, 3)
        ids = rng.integers(1, 4, 24).astype(np.int32)
        pts = np.round(_in_boxes(rng, boxes, ids))
        mirror = pts + np.asarray([2.0, 0.0, 0.0], np.float32)
        return masks, np.concatenate([pts, mirror, pts]), np.concatenate([ids, ids, ids])
    if name == "padding":
        # id-0 points between and after the real ones, placed where they
        # would win if they matched
        masks, boxes = _boxes(rng, SHAPE, 3)
        ids = rng.integers(1, 4, 60).astype(np.int32)
        pts = _in_boxes(rng, boxes, ids)
        ids[::5] = 0
        return masks, pts, ids
    if name == "no-points":
        masks, boxes = _boxes(rng, SHAPE, 4)
        ids = rng.integers(1, 3, 40).astype(np.int32)  # instances 3 and 4 have none
        return masks, _in_boxes(rng, boxes, ids), ids
    if name == "over-cap":
        # 12 ids in the first tile (more than CAP), a box elsewhere
        masks, boxes = _boxes(rng, SHAPE, 2)
        masks[:4, :8, :8] = rng.integers(3, 15, (4, 8, 8))
        ids = rng.integers(1, 15, 300).astype(np.int32)
        pts = (rng.random((300, 3)) * np.asarray(SHAPE)).astype(np.float32)
        return masks, pts, ids
    if name == "sparse-loss":
        # the sparse loss's call: all voxels one instance, a quarter padding
        p = 256
        masks = np.ones(SHAPE, np.int32)
        pts = (rng.random((p, 3)) * np.asarray(SHAPE)).astype(np.float32)
        return masks, pts, (np.arange(p) < p - p // 4).astype(np.int32)
    raise ValueError(name)


CASES = ["duplicates", "padding", "no-points", "over-cap", "sparse-loss"]


@pytest.mark.parametrize("name", CASES)
def test_lists_match_plain_version_and_pallas(name):
    """Bit for bit against ``bake_skeleton_ref`` (and the wrapper's CPU
    path); against the Pallas kernel in interpret mode the same points bit
    for bit, and distances within 1e-6 relative: XLA:CPU contracts the
    kernel's d2 sum into FMAs, so its minimum d2 can sit an ulp or two
    from the separately rounded one (the card's kernel rounds each op as
    the plain version does). The over-cap case takes the full scan in the
    tile it overfills and the lists elsewhere."""
    masks, pts, ids = case(name)
    m, p, i = torch.from_numpy(masks), torch.from_numpy(pts), torch.from_numpy(ids)
    got_b, got_d, branches = bake_lists_emulated(m, p, i)
    want_b, want_d = bake_skeleton_ref(m, p, i, ANISO)
    assert torch.equal(got_b, want_b) and torch.equal(got_d, want_d)
    cpu_b, cpu_d = bake_skeleton_kernel(m, p, i, ANISO)
    assert torch.equal(cpu_b, want_b) and torch.equal(cpu_d, want_d)
    jb, jd = bake_skeleton_pallas(jnp.asarray(masks), jnp.asarray(pts), jnp.asarray(ids),
                                  anisotropy=ANISO, interpret=True)
    assert np.array_equal(np.asarray(jb), got_b.numpy())
    np.testing.assert_allclose(np.asarray(jd), got_d.numpy(), rtol=1e-6, atol=0)
    if name == "over-cap":
        assert branches[0] == "full scan" and "listed" in branches
    else:
        assert "full scan" not in branches and "listed" in branches


def test_lists_that_overflow_take_the_full_scan():
    """A list capacity of 256 against 300 own-instance points of one tile:
    that tile scans every point with the id compare, bit-equal all the same."""
    rng = np.random.default_rng(11)
    masks = np.zeros(SHAPE, np.int32)
    masks[:4, :16, :16] = 1
    masks[4:, 16:, :] = 2
    ids = np.where(rng.random(600) < 0.5, 1, 2).astype(np.int32)
    pts = (rng.random((600, 3)) * np.asarray(SHAPE)).astype(np.float32)
    m, p, i = torch.from_numpy(masks), torch.from_numpy(pts), torch.from_numpy(ids)
    got_b, got_d, branches = bake_lists_emulated(m, p, i, lmax=256)
    assert branches[0] == "full scan"
    want_b, want_d = bake_skeleton_ref(m, p, i, ANISO)
    assert torch.equal(got_b, want_b) and torch.equal(got_d, want_d)
    assert list_capacity(600) == 608 and list_capacity(100) == 256
    assert list_capacity(5000) == LMAX
