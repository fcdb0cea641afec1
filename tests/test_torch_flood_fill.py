"""The host engine's connected components (``ops/flood_fill.py``) against
the JAX package's on the same seeded numpy volumes, on the CPU: the labels,
the tile compaction order, the seam merges and the in-place finishers are
compared for exact equality (the final renumber depends on label order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.ops import flood_fill as jff
from skoots_tpu_torch.ops import flood_fill as tff


def _sparse(shape, density, seed):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.uint8)


@pytest.mark.parametrize("conn", [26, 6])
@pytest.mark.parametrize("props,jumps", [(1, 2), (3, 0), (4, 1)])
def test_label_components_matches_jax(conn, props, jumps):
    # below the percolation threshold of each connectivity: many components
    mask = _sparse((24, 20, 16), 0.1 if conn == 26 else 0.25, seed=conn + props)
    want, wconv = jff.label_components(
        jnp.asarray(mask), max_rounds=64, connectivity=conn,
        propagates_per_round=props, jumps_per_round=jumps, return_converged=True)
    got, gconv = tff.label_components(
        torch.from_numpy(mask), max_rounds=64, connectivity=conn,
        propagates_per_round=props, jumps_per_round=jumps, return_converged=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gconv and bool(wconv)
    assert len(np.unique(np.asarray(want))) > 10


@pytest.mark.parametrize("conn", [26, 6])
def test_label_components_unconverged_matches_jax(conn):
    """Too few rounds for a long path (pure propagation, 2 hops a round):
    the same partial labels and ``converged`` False on both sides."""
    mask = np.zeros((4, 40, 4), np.uint8)
    mask[1, :, 1] = 1
    kw = dict(max_rounds=5, connectivity=conn, propagates_per_round=2,
              jumps_per_round=0, return_converged=True)
    want, wconv = jff.label_components(jnp.asarray(mask), **kw)
    got, gconv = tff.label_components(torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not gconv and not bool(wconv)
    assert len(np.unique(np.asarray(want))) > 2


def _tubes_and_speckle(shape=(40, 36, 32)):
    """Random speckle plus a few long straight runs that cross every tile
    seam, so seam merges chain over several tiles."""
    m = _sparse(shape, 0.18, seed=5)
    m[3, :, 9] = 1
    m[:, 20, 17] = 1
    m[30, 5, :] = 1
    m[10:30, 10:30, 24] = np.eye(20, dtype=np.uint8)  # a diagonal in-plane run
    return m


@pytest.mark.parametrize("compact,wire_thrift", [(True, False), (None, True),
                                                 (False, False)])
def test_efficient_flood_fill_matches_jax(compact, wire_thrift):
    """A (16, 16, 16) crop over (40, 36, 32): 18 tiles with seams on every
    axis; compacted labels (with the bit-packed upload and 16-bit download
    under ``wire_thrift``) or the fast per-tile offsets."""
    mask = _tubes_and_speckle()
    jinfo, tinfo = {}, {}
    want = jff.efficient_flood_fill(mask, crop_size=(16, 16, 16), compact=compact,
                                    wire_thrift=wire_thrift, info=jinfo)
    got = tff.efficient_flood_fill(mask, crop_size=(16, 16, 16), compact=compact,
                                   wire_thrift=wire_thrift, info=tinfo, device="cpu")
    assert len(jff.crop_origins(mask.shape, (16, 16, 16))) >= 8
    np.testing.assert_array_equal(got, want)
    assert tinfo["max_label"] == jinfo["max_label"]
    assert tinfo["rounds"] >= len(jff.crop_origins(mask.shape, (16, 16, 16)))
    # the seams merged something: fewer ids than the tiles' components
    assert len(np.unique(want)) < (jinfo["max_label"] or np.inf)


def test_efficient_flood_fill_into_memmap_matches_jax(tmp_path):
    """Out of core: the labels written in place into a ``.npy`` memmap, then
    renumbered in place, chunk by chunk."""
    mask = _tubes_and_speckle()
    jout = np.lib.format.open_memmap(str(tmp_path / "j.npy"), mode="w+",
                                     dtype="int32", shape=mask.shape)
    tout = np.lib.format.open_memmap(str(tmp_path / "t.npy"), mode="w+",
                                     dtype="int32", shape=mask.shape)
    jff.efficient_flood_fill(mask, crop_size=(16, 16, 8), out=jout)
    got = tff.efficient_flood_fill(mask, crop_size=(16, 16, 8), out=tout,
                                   device="cpu")
    assert got is tout
    np.testing.assert_array_equal(np.asarray(tout), np.asarray(jout))
    assert tff.renumber_inplace(tout) == jff.renumber_inplace(jout)
    np.testing.assert_array_equal(np.asarray(tout), np.asarray(jout))


def test_drop_small_instances_memmap_in_place_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    lab = np.zeros((24, 16, 8), np.int32)
    for i in range(1, 9):
        lab[rng.integers(0, 24, 2000 if i < 7 else 2), rng.integers(0, 16, 2000 if i < 7 else 2),
            rng.integers(0, 8, 2000 if i < 7 else 2)] = i * 7
    arrays = []
    for side, fn in (("j", jff.drop_small_instances), ("t", tff.drop_small_instances)):
        mm = np.lib.format.open_memmap(str(tmp_path / f"{side}.npy"), mode="w+",
                                       dtype="int32", shape=lab.shape)
        mm[:] = lab
        out, n = fn(mm, -1)
        assert out is mm and n == 2
        arrays.append(np.asarray(mm))
    np.testing.assert_array_equal(arrays[1], arrays[0])


def test_compact_and_unpack_helpers_match_jax():
    mask = _sparse((12, 10, 16), 0.08, seed=9)
    lab = np.array(jff.label_components(jnp.asarray(mask)))
    want, wn = jff._compact_labels(jnp.asarray(lab))
    got, gn = tff._compact_labels(torch.from_numpy(lab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gn == int(wn) > 5
    packed = np.packbits(mask > 0, axis=-1)
    np.testing.assert_array_equal(
        tff._unpack_bits_dev(torch.from_numpy(packed)).numpy(),
        np.asarray(jff._unpack_bits_dev(jnp.asarray(packed))))
    a, b = lab[4], lab[5]
    np.testing.assert_array_equal(tff._seam_pairs(a, b), jff._seam_pairs(a, b))


def test_efficient_flood_fill_sparse_matches_jax():
    """``cc_impl="sparse"``: every tile of the seam case labelled by the
    point-cloud CC (no dense round), the seams merged as JAX merges them,
    and the dense engine's labels."""
    mask = _tubes_and_speckle()
    want = jff.efficient_flood_fill(mask, crop_size=(16, 16, 16), cc_impl="sparse")
    info = {}
    got = tff.efficient_flood_fill(mask, crop_size=(16, 16, 16), cc_impl="sparse",
                                   info=info, device="cpu")
    np.testing.assert_array_equal(got, want)
    n_tiles = len(jff.crop_origins(mask.shape, (16, 16, 16)))
    assert info["cc_tiles"] == {"sparse": n_tiles, "dense": 0} and info["rounds"] == 0
    np.testing.assert_array_equal(
        got, tff.efficient_flood_fill(mask, crop_size=(16, 16, 16), device="cpu"))
