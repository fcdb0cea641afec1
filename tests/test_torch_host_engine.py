"""The port's host-streaming engine (``infer/engine.py``) against the JAX
package's, on the CPU, and the entry points' device rule.

* A tiny f32 checkpoint with random weights through both engines, with a
  tile grid of several overlapping tiles per axis: ``store`` and
  ``recompute`` wire modes and out of core (memmaps). Both forwards are f32
  with sums in other orders, so a probability next to a threshold could
  flip; the masks are compared voxel for voxel and must be equal.
* ``--use-cached`` across packages: the port reads the phase-1 cache the
  JAX engine wrote with the bench checkpoint (bf16, full width) and must
  write exactly JAX's mask -- phases 2 and 3 at exact parity, whatever the
  forwards' ulps.
* The bench checkpoint through both host engines on three tubes: same
  instance count, every instance at IoU >= 0.95.
* Both CLIs with their default flags on a small volume: the engine choice
  is JAX's (host at <= 256^3), so the masks are equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skoots_tpu.cli import main as jax_cli
from skoots_tpu.config import get_cfg_defaults
from skoots_tpu.infer.engine import run_inference as jax_run
from skoots_tpu.models import init_model
from skoots_tpu.train.checkpoint import save_checkpoint
from skoots_tpu.utils.io import imread as jax_imread
from skoots_tpu.utils.io import imsave as jax_imsave
from skoots_tpu.utils.synthetic import make_tubes
from skoots_tpu_torch.cli import main as torch_cli
from skoots_tpu_torch.infer import device_pipeline as tdp
from skoots_tpu_torch.infer.engine import run_inference as torch_run
from skoots_tpu_torch.utils.synthetic import render_tubes

from test_torch_pipeline import _match_instances, _straight_tubes

BENCH = "runs/bench_ckpt.skoots"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(checkpoint path, u8 volume (40, 40, 24), checkpoint path) of a tiny
    f32 UNeXT with random weights of a useful scale and vector scale
    (4, 4, 2). The second checkpoint raises the skeleton head's bias by 1
    and the semantic head's by 2 and shrinks the vector head, so the
    default threshold 0.8 finds many short walks to many skeletons.""" 
    cfg = get_cfg_defaults()
    cfg.defrost()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 4], [1, 1, 1]
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 8, 3
    cfg.MODEL.DTYPE = "float32"
    cfg.SKOOTS.VECTOR_SCALING = [4.0, 4.0, 2.0]
    cfg.freeze()
    _, params = init_model(cfg, jax.random.PRNGKey(0), spatial=(8, 8, 4))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.5, jnp.float32), params)
    d = tmp_path_factory.mktemp("tiny")
    ckpt = str(d / "tiny.skoots")
    img, _, _ = make_tubes(shape=(40, 40, 24), n_tubes=3, seed=2)
    save_checkpoint(ckpt, cfg, params, dataset_mean=float(img.mean()),
                    dataset_std=float(img.std()))
    hot = jax.tree_util.tree_map(lambda a: a, params)
    heads = hot["params"]
    heads["skeleton_head"]["bias"] = heads["skeleton_head"]["bias"] + 1.0
    heads["semantic_head"]["bias"] = heads["semantic_head"]["bias"] + 2.0
    heads["vector_head"]["kernel"] = heads["vector_head"]["kernel"] * 0.1
    heads["vector_head"]["bias"] = heads["vector_head"]["bias"] * 0.0
    hot_ckpt = str(d / "tiny_hot.skoots")
    save_checkpoint(hot_ckpt, cfg, hot, dataset_mean=float(img.mean()),
                    dataset_std=float(img.std()))
    return ckpt, img, hot_ckpt


def _both(tmp_path, ckpt, img, **kw):
    """Run both host engines on copies of ``img``; returns (jax, torch)
    masks and the two stems."""
    masks, stems = [], []
    for side, run in (("jax", jax_run), ("torch", torch_run)):
        path = str(tmp_path / f"{side}.npy")
        np.save(path, img)
        extra = {"device": "cpu"} if side == "torch" else {}
        out = run(path, ckpt, output_path=str(tmp_path / f"{side}_mask.npy"),
                  **kw, **extra)
        masks.append(np.asarray(out))
        stems.append(str(tmp_path / side))
    return masks, stems


TINY_KW = dict(crop_size=(24, 24, 16), overlap=(4, 4, 2),
               assign_crop_size=(32, 32, 16), assign_overlap=(4, 4, 2),
               prob_threshold=0.6, embed_iterations=4, dilation_3d=1,
               dilation_2d=1, engine_impl="host")


@pytest.mark.parametrize("mode", ["store", "recompute", "out_of_core"])
def test_host_engine_matches_jax_tiny_f32(tmp_path, tiny, mode):
    ckpt, img, _ = tiny
    kw = dict(TINY_KW, wire_mode="auto" if mode == "out_of_core" else mode)
    if mode == "out_of_core":
        kw["out_of_core"] = True
    (want, got), stems = _both(tmp_path, ckpt, img, **kw)
    flips = int((want != got).sum())
    print(f"{mode}: {len(np.unique(want)) - 1} instances, {flips} voxels differ")
    assert flips == 0
    assert len(np.unique(want)) - 1 >= 3
    phases = json.load(open(stems[1] + "_skoots_phases.json"))
    assert phases["engine"] == "host" and phases["phase1"]["tiles"] >= 8
    assert phases["wire_mode"] == ("recompute" if mode != "store" else "store")
    assert set(phases["phase3"]) >= {"read_s", "embed_s", "labelcrop_s",
                                     "gather_s", "write_s"}
    for suffix in ("_skoots_skeleton.npy", "_skoots_semantic.npy",
                   "_skoots_phase1.json"):
        a = stems[0] + suffix
        b = stems[1] + suffix
        if suffix.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a))
        else:
            assert json.load(open(b)) == json.load(open(a))
    assert os.path.exists(stems[1] + "_skoots_vectors.npy") == (mode == "store")
    if mode == "out_of_core":
        assert os.path.exists(stems[1] + "_skoots_labels.npy")


def test_host_engine_slab_fallback_matches_jax(tmp_path, tiny):
    """A label-crop budget below any walk's bbox: every batch streams
    x-slabs of the labels instead."""
    ckpt, img, _ = tiny
    (want, got), stems = _both(tmp_path, ckpt, img, label_crop_budget_bytes=1,
                               **TINY_KW)
    np.testing.assert_array_equal(got, want)
    phases = json.load(open(stems[1] + "_skoots_phases.json"))
    assert phases["phase3"]["streamed_batches"] == phases["phase3"]["tiles"]


@pytest.fixture(scope="module")
def bench_three_tubes(tmp_path_factory):
    """The JAX host engine on three tubes with the bench checkpoint: (dir,
    image path, JAX mask). It leaves its phase-1 cache beside the image."""
    d = tmp_path_factory.mktemp("bench")
    img, _ = _straight_tubes((48, 48, 16), [((10, 4, 8), (10, 44, 8)),
                                            ((26, 4, 8), (26, 44, 8)),
                                            ((40, 6, 7), (38, 42, 9))])
    path = str(d / "jax.npy")
    np.save(path, img)
    want = np.asarray(jax_run(path, BENCH, dilation_3d=0, dilation_2d=1,
                              engine_impl="host", output_path=str(d / "jax_mask.npy")))
    return d, path, want


def test_use_cached_reads_jax_cache_exactly(bench_three_tubes):
    """The port's phases 2 and 3 on the JAX engine's phase-1 cache (bench
    checkpoint, bf16, full width): exactly JAX's mask."""
    d, path, want = bench_three_tubes
    got = torch_run(path, BENCH, use_cached_data=True, dilation_3d=0, dilation_2d=1,
                    output_path=str(d / "torch_cached_mask.npy"), device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) - 1 == 3


def test_host_engine_bench_checkpoint_matches_jax(bench_three_tubes, tmp_path):
    d, _, want = bench_three_tubes
    img = np.load(str(d / "jax.npy"))
    path = str(tmp_path / "torch.npy")
    np.save(path, img)
    got = torch_run(path, BENCH, dilation_3d=0, dilation_2d=1, device="cpu",
                    output_path=str(tmp_path / "torch_mask.npy"))
    n_want, n_got, ious = _match_instances(want, got)
    print(f"instances jax {n_want} torch {n_got}; IoUs {[round(i, 4) for i in ious]}")
    assert n_want == 3 and n_got == n_want
    assert min(ious) >= 0.95


def test_both_clis_default_flags_give_equal_masks(tmp_path, tiny):
    """``skoots --image`` and ``skoots-torch --image`` with their defaults
    (the port's only extra flag: ``--device cpu``). X < 16 keeps JAX's auto
    spatial sharding off on the test's 8 virtual CPU devices, so JAX picks
    its host engine, as it does on one device; the port must pick it too.
    The default crop 300x300x20 with overlap 50,50,5 gives 4 z tiles."""
    _, _, ckpt = tiny
    img, _, _ = make_tubes(shape=(12, 40, 48), n_tubes=3, radius=3, seed=4)
    for side in ("jax", "torch"):
        jax_imsave(str(tmp_path / f"{side}.tif"), img)
    common = ["--pretrained-checkpoint", ckpt, "--log", "1"]
    jax_cli(["--image", str(tmp_path / "jax.tif")] + common)
    assert torch_cli(["--image", str(tmp_path / "torch.tif"), "--device", "cpu"]
                     + common) == 0
    want = jax_imread(str(tmp_path / "jax_instance_mask.tif"))
    got = jax_imread(str(tmp_path / "torch_instance_mask.tif"))
    phases = json.load(open(tmp_path / "torch_skoots_phases.json"))
    assert phases["engine"] == "host" and phases["phase1"]["tiles"] >= 4
    print(f"{len(np.unique(want)) - 1} instances, "
          f"{int((got != want).sum())} voxels differ")
    assert len(np.unique(want)) - 1 >= 10
    np.testing.assert_array_equal(got, want)


def test_entry_points_without_cuda_raise(tmp_path, tiny):
    """With no device given the entry points run on the card; without one
    they raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points would run on it")
    ckpt, img, _ = tiny
    path = str(tmp_path / "v.npy")
    np.save(path, img)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_run(path, ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cli(["--image", path, "--pretrained-checkpoint", ckpt, "--log", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tdp.make_chunked_pipeline(torch.nn.Identity(), (8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        render_tubes((8, 8, 8), np.zeros((1, 3)), np.ones((1, 3)))
    assert not os.path.exists(str(tmp_path / "v_instance_mask.tif"))


def test_auto_engine_is_host_on_cpu(tmp_path, tiny):
    """On the CPU no device limit exists, so ``auto`` is the host engine at
    any size, as JAX's on the CPU."""
    ckpt, img, _ = tiny
    path = str(tmp_path / "v.npy")
    np.save(path, img)
    torch_run(path, ckpt, device="cpu", output_path=str(tmp_path / "m.npy"),
              **dict(TINY_KW, engine_impl="auto"))
    assert json.load(open(tmp_path / "v_skoots_phases.json"))["engine"] == "host"
