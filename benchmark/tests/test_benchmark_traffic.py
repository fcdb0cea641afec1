"""The traffic generators against the program's phantom, and their speed."""

import time

import numpy as np
import pytest
import torch

from benchmark.traffic import tube_blocks, tube_records
from skoots_tpu_torch.utils import synthetic


@pytest.mark.parametrize("shape,n,seed", [((512, 512, 512), 48, 7), ((256, 256, 64), 30, 3),
                                          ((600, 600, 64), 24, 11), ((512, 512, 512), 150, 5),
                                          ((128, 96, 40), 10, 2**40 + 3)])
def test_grid_segments_equal_the_program_s(shape, n, seed):
    a = tube_blocks.tube_segments(shape, n, 5.0, seed, 14.0)
    b = synthetic.tube_segments(shape, n, 5.0, seed, 14.0)
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_400_tubes_quickly():
    t = time.perf_counter()
    _, _, n = tube_blocks.tube_segments((512, 512, 512), 400, 5.0, 12345, 14.0)
    assert n == 400
    assert time.perf_counter() - t < 2.0


def test_render_equals_the_program_s():
    p0, p1, _ = tube_blocks.tube_segments((48, 40, 24), 4, 3.0, 9, 8.0)
    a = tube_blocks.render_tubes((48, 40, 24), p0, p1, 3.0, 160.0, 40.0, 12.0, 1, "cpu")
    b = synthetic.render_tubes((48, 40, 24), p0, p1, radius=3.0, seed=1, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_blocks_repeat_per_seed_and_differ_between_seeds():
    mix = {"shape": [64, 64, 32], "blocks": 2, "tubes": 4, "radius": 4.0,
           "min_separation": 10.0, "fg": 160.0, "bg": 40.0, "noise": 12.0}
    a = tube_blocks.make(mix, 2**33 + 1, "cpu")
    b = tube_blocks.make(mix, 2**33 + 1, "cpu")
    c = tube_blocks.make(mix, 2**33 + 2, "cpu")
    assert all(np.array_equal(x["volume"], y["volume"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["volume"], c[0]["volume"])
    assert a[0]["volume"].dtype == np.uint8


def test_records_labels_and_axes():
    mix = {"shape": [96, 96, 24], "volumes": 1, "tubes": 5, "radius": 4.0,
           "min_separation": 10.0, "fg": 160.0, "bg": 40.0, "noise": 12.0}
    (rec,) = tube_records.make(mix, 77, "cpu")
    masks, skel = rec["masks"], rec["skeletons"]
    assert set(np.unique(masks)) - {0} == set(skel)
    for k, pts in skel.items():
        # every axis point lies inside its own tube (where it is in the volume)
        idx = np.round(pts).astype(int)
        inside = np.all((idx >= 0) & (idx < np.array(masks.shape)), axis=1)
        lab = masks[tuple(idx[inside].T)]
        assert (lab == k).mean() > 0.95
        assert np.all(np.linalg.norm(np.diff(pts, axis=0), axis=1) <= 1.0 + 1e-4)
