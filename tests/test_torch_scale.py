"""The port's scale tools (``skoots_tpu_torch/tools/bigvol_proof.py`` and
``seam_bench_agreement.py``) against the JAX repo's (``tools/``), and the
engine at the volumes those tools reach:

* the phantoms voxel for voxel equal to JAX's;
* the proof tool's ``main`` on the CPU at 64x64x32 with the bench
  checkpoint (the JAX tool's keys and the port's, the mask, ``vs_gt``), and
  its out-of-core host run equal to the in-RAM one;
* ``auto``'s choice and estimates at 1024^3, 1280^3 and 2^31 voxels from a
  faked free-bytes limit and tile bytes, allocating nothing;
* the in-RAM finishers' host memory, which a whole-volume int64 remap made
  about 34 B a voxel;
* the host engine's tiled CC on a serpentine that needs more than its 64
  rounds (it stopped there and split the component);
* the seam tool's ``main`` at a tiny shape.
"""

import importlib.util
import json
import os
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from skoots_tpu_torch.infer import engine
from skoots_tpu_torch.infer.device_pipeline import estimated_device_bytes
from scipy import ndimage

from skoots_tpu_torch.ops.flood_fill import (drop_small_instances, efficient_flood_fill,
                                             renumber)
from skoots_tpu_torch.tools import bigvol_proof, seam_bench_agreement
from skoots_tpu_torch.utils.io import open_outofcore

ROOT = Path(__file__).resolve().parents[1]
BENCH_CKPT = str(ROOT / "runs" / "bench_ckpt.skoots")
GB = 10**9

# the JAX tool's result keys (tools/bigvol_proof.py:234-262) and the port's
JAX_KEYS = {"shape", "voxels", "wall_s", "vox_per_s", "synth_s", "n_instances",
            "peak_anon_rss_mb", "peak_rss_incl_page_cache_mb", "tracemalloc_delta_mb",
            "device_memory_stats", "out_of_core", "backend", "phantom", "checkpoint",
            "phases", "engine"}
PORT_KEYS = {"engine_ran", "auto", "estimated_bytes", "reserved_peak_bytes",
             "cc_rounds", "cc_converged", "n_placed", "vs_gt", "name", "power_limit",
             "peak_vm_rss_mb"}


def jax_tool(name: str):
    """A JAX repo tool (a script under ``tools/``, not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: on one thread, so the suite's parallel workers do
    not wait on each other's thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [7, 11])
@pytest.mark.parametrize("shape,n_tubes", [((128, 96, 48), 6), ((96, 160, 64), 9)])
def test_make_tubes_big_equals_jaxs(shape, n_tubes, seed):
    """Image, labels and the tubes placed: equal, also when the labels go
    into a memmap-like preallocated array."""
    ref = jax_tool("seam_bench_agreement").make_tubes_big(shape, n_tubes, seed=seed)
    got = seam_bench_agreement.make_tubes_big(shape, n_tubes, seed=seed)
    into = seam_bench_agreement.make_tubes_big(shape, n_tubes, seed=seed,
                                               labels=np.zeros(shape, np.int32))
    assert ref[2] == got[2] == into[2] > 0
    for out in (got, into):
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
        assert out[0].dtype == np.uint8 and out[1].dtype == np.int32


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape", [(64, 48, 32), (96, 32, 48)])  # JAX's needs multiples of 16
def test_synthesize_equals_jaxs(tmp_path, shape, seed):
    jax_tool("bigvol_proof").synthesize(str(tmp_path / "jax.npy"), shape, seed=seed)
    bigvol_proof.synthesize(str(tmp_path / "port.npy"), shape, seed=seed)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"),
                                  np.load(tmp_path / "jax.npy"))


@pytest.fixture(scope="module")
def proof_run(tmp_path_factory):
    """The tool's ``main`` on the CPU: the tubes phantom at 64x64x32 with the
    bench checkpoint, the host engine out of core, one forward tile (crop
    64x64x32, no overlap), the vectors stored rather than recomputed in
    phase 3 (``SKOOTS_WIRE_MODE=store``) so the run makes two forwards."""
    out = tmp_path_factory.mktemp("bigvol")
    mp = pytest.MonkeyPatch()
    mp.setenv("SKOOTS_WIRE_MODE", "store")
    mp.setenv("SKOOTS_NO_TRACEMALLOC", "1")
    try:
        rc = bigvol_proof.main([
            "--shape", "64,64,32", "--phantom", "tubes", "--n-tubes", "4",
            "--ckpt", BENCH_CKPT, "--device", "cpu", "--outdir", str(out),
            "--tag", "cpu", "--crop", "64,64,32", "--overlap", "0,0,0"])
    finally:
        mp.undo()
    assert rc == 0
    return out, json.loads((out / "result_cpu.json").read_text())


def test_proof_main_on_the_cpu(proof_run):
    out, result = proof_run
    assert JAX_KEYS <= set(result) and PORT_KEYS <= set(result), \
        (JAX_KEYS | PORT_KEYS) - set(result)
    assert result["engine"] == result["engine_ran"] == "host"
    assert result["out_of_core"] is True and result["backend"] == "cpu"
    assert result["cc_converged"] is True and result["cc_rounds"] > 0
    assert result["estimated_bytes"] is None and result["device_memory_stats"] == {}
    mask = np.load(out / "instance_cpu.npy")
    gt = np.load(out / "bigvol_tubes_labels.npy")
    assert mask.shape == gt.shape == (64, 64, 32) and mask.dtype == np.int32
    assert result["n_instances"] == mask.max() and result["n_placed"] == gt.max() >= 1
    assert set(result["vs_gt"]) >= {"f1_at_iou50", "mean_iou", "tp", "fp", "fn"}
    assert result["vs_gt"]["gt_instances"] == result["n_placed"]
    # the phantom is the JAX tool's, seed 11
    img, labels, n = jax_tool("seam_bench_agreement").make_tubes_big(
        (64, 64, 32), 4, radius=5.0, seed=11, min_separation=14.0)
    np.testing.assert_array_equal(np.load(out / "bigvol_tubes.npy"), img)
    np.testing.assert_array_equal(gt, labels)
    assert n == result["n_placed"]


def test_out_of_core_equals_in_ram(proof_run, monkeypatch):
    """``run_inference`` over memmaps (the tool's run) and in RAM, with the
    knobs the first run baked into its phase-1 buffers: the same mask."""
    out, _ = proof_run
    knobs = json.loads((out / "bigvol_tubes_skoots_phase1.json").read_text())
    monkeypatch.setenv("SKOOTS_WIRE_MODE", "store")
    monkeypatch.setenv("SKOOTS_NO_TRACEMALLOC", "1")
    in_ram = engine.run_inference(
        str(out / "bigvol_tubes.npy"), BENCH_CKPT, crop_size=(64, 64, 32),
        overlap=(0, 0, 0), assign_crop_size=bigvol_proof.ASSIGN_CROP,
        assign_overlap=bigvol_proof.ASSIGN_OVERLAP, out_of_core=False,
        dilation_3d=knobs["dilation_3d"], dilation_2d=knobs["dilation_2d"],
        output_path=str(out / "in_ram.npy"), device="cpu")
    assert engine.last_stats["out_of_core"] is False
    assert not isinstance(in_ram, np.memmap)
    np.testing.assert_array_equal(in_ram, np.load(out / "instance_cpu.npy"))


TILE = 9_500_000_000  # about one forward tile's reserved peak on the card


@pytest.mark.parametrize("shape,free,engine_name", [
    ((1024,) * 3, 79 * GB, "device"),
    ((1024,) * 3, 30 * GB, "device-thrifty"),
    ((1024,) * 3, 20 * GB, "host"),
    ((1280,) * 3, 79 * GB, "device"),
    ((1280,) * 3, 40 * GB, "device-thrifty"),
    ((2048, 1024, 1024), 79 * GB, "host"),    # 2^31: past the int32 addresses
    ((2048, 1024, 1024), 10**15, "host"),
])
def test_auto_choice_and_estimates_at_scale(shape, free, engine_name):
    """``choose_engine`` from a faked free-bytes limit and tile bytes: the
    estimates are 24 (chunked) and 13 (thrifty, uint8) bytes a voxel plus
    the tile, and nothing is allocated."""
    vox = int(np.prod(shape, dtype=np.int64))
    choice, est = engine.choose_engine(shape, 1, free, TILE)
    assert est == {"device": 24 * vox + TILE, "device-thrifty": 13 * vox + TILE}
    assert est["device"] == estimated_device_bytes(shape, tile_bytes=TILE)
    assert choice == engine_name


def test_auto_estimates_at_1024_and_the_ceiling():
    """The numbers the proof runs rely on: 1024^3 estimates 25.77 GB + the
    tile, 1280^3 50.33 GB + the tile, both under an H100's 80 GB."""
    assert estimated_device_bytes((1024,) * 3) == 25_769_803_776
    assert estimated_device_bytes((1280,) * 3) == 50_331_648_000
    assert (1280**3 < 2**31 <= 2048 * 1024 * 1024)


class _Chosen(Exception):
    pass


@pytest.mark.parametrize("shape,want", [((1024,) * 3, "device"),
                                        ((2048, 1024, 1024), "host")])
def test_run_inference_auto_at_scale(tmp_path, monkeypatch, shape, want):
    """``run_inference``'s wiring of ``auto`` on a sparse (never written)
    ``.npy`` of the volume: the faked free bytes and tile bytes reach
    ``choose_engine``, ``last_stats['auto']`` records them, and at 2^31
    voxels the host engine, not a pipeline whose CC would raise, is what
    starts."""
    path = str(tmp_path / "vol.npy")
    vol = open_outofcore(path, shape, "uint8")
    del vol
    assert os.stat(path).st_blocks * 512 < 10**8  # sparse on disk
    monkeypatch.setattr(engine.sharded, "device_bytes_limit", lambda device: 79 * GB)
    monkeypatch.setattr(engine, "_forward_tile_bytes", lambda *a, **k: TILE)

    def device_engine(*args):
        raise _Chosen("device-thrifty" if args[-1] else "device")

    def sweep(*args, **kwargs):
        raise _Chosen("host")

    monkeypatch.setattr(engine, "_run_device_engine", device_engine)
    monkeypatch.setattr(engine, "_sweep", sweep)
    monkeypatch.setenv("SKOOTS_NO_TRACEMALLOC", "1")
    with pytest.raises(_Chosen) as chosen:
        engine.run_inference(path, BENCH_CKPT, crop_size=(192, 192, 96),
                             overlap=(8, 8, 4), assign_crop_size=(256, 256, 64),
                             assign_overlap=(8, 8, 4), dilation_3d=1, dilation_2d=2,
                             device="cpu")
    assert str(chosen.value) == want
    auto = engine.last_stats["auto"]
    vox = int(np.prod(shape, dtype=np.int64))
    assert auto == {"free_bytes": 79 * GB, "tile_bytes": TILE,
                    "estimated_bytes": {"device": 24 * vox + TILE,
                                        "device-thrifty": 13 * vox + TILE}}


def _traced_peak(fn) -> int:
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_in_ram_finishers_work_in_chunks():
    """The speck filter and ``renumber`` on an in-RAM mask hold the output
    and chunk-sized temporaries: a whole-volume int64 remap held about 34 B
    a voxel (70 GB of host RAM at 1280^3). Same results as the remap
    of the whole volume."""
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 5000, (256, 64, 64)) * 7).astype(np.int32)
    x[rng.random(x.shape) < 0.5] = 0
    dropped, n = drop_small_instances(x, 120)
    assert n > 0
    keys = np.unique(x)[1:]
    counts = np.bincount(np.searchsorted(keys, x[x > 0]), minlength=len(keys))
    np.testing.assert_array_equal(dropped, np.where(np.isin(x, keys[counts < 120]), 0, x))
    out, mapping = renumber(dropped)
    assert out.dtype == np.int32 and out.max() == len(mapping) == len(np.unique(dropped)) - 1
    np.testing.assert_array_equal(out, np.searchsorted(np.unique(dropped), dropped))
    for fn in (lambda: drop_small_instances(x, 120), lambda: renumber(x)):
        assert _traced_peak(fn) < 6 * x.size


def test_host_cc_runs_a_long_thin_path_to_its_fixpoint():
    """A serpentine of 96-voxel rows (each round of one propagation pass and
    two pointer jumps gains about one voxel on it) beside an isolated
    voxel: the tile needs ~97 rounds; stopped at 64 it came out in 8
    pieces. It must be labelled exactly as scipy's connected components,
    and ``info`` must say the tile ran past the bound."""
    m = np.zeros((24, 96, 8), np.uint8)
    for x in range(0, 24, 2):
        m[x, :, 0] = 1
        if x + 1 < 24:
            m[x + 1, 95 if (x // 2) % 2 == 0 else 0, 0] = 1
    m[12, 48, 4] = 1
    info = {}
    out = efficient_flood_fill(m, crop_size=(32, 96, 8), info=info, device="cpu")
    ref, n = ndimage.label(m, np.ones((3, 3, 3)))
    assert n == 2 and len(np.unique(out)) - 1 == n
    assert len(np.unique(ref.astype(np.int64) * (n + 1) + out)) == n + 1
    np.testing.assert_array_equal(out > 0, m > 0)
    assert info["converged"] is False and info["unconverged_tiles"] == 1
    assert info["rounds"] > 64 + 64


def _tiny_cfg():
    """A small random model's cfg: the tools' and pipelines' paths, not
    their accuracy."""
    from skoots_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.MODEL.DIMS, cfg.MODEL.DEPTHS = [4, 8, 16, 8, 4], [1] * 5
    cfg.MODEL.OUT_CHANNELS, cfg.MODEL.KERNEL_SIZE = 4, 3
    return cfg


class _VolumeAllocations(TorchDispatchMode):
    """Counts the new f32 storages of at least ``voxels`` elements that ops
    allocate (an output whose storage is no input's: not a view, not an
    in-place result)."""

    def __init__(self, voxels: int):
        super().__init__()
        self.voxels, self.count = voxels, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and t.numel() >= self.voxels
                    and t.untyped_storage().data_ptr() not in ins):
                self.count += 1
        return out


def test_chunked_pipeline_holds_one_f32_volume():
    """The estimate's accounting (``estimated_device_bytes``): phase 1 of
    the chunked pipeline allocates one f32 volume, the normalised and
    reflect-padded input, built in place. The chain it replaces,
    ``reflect_pad((v.float() - mean) / std)``, allocated six, and on the
    card each stayed in the allocator's cache: the 1024^3 run reserved
    35.1 GB against the 32.1 GB estimate (27 B a voxel over the tile). Its
    values are the chain's, bit for bit."""
    from skoots_tpu_torch.infer import device_pipeline as tdp
    from skoots_tpu_torch.models.registry import init_model

    model = init_model(_tiny_cfg(), 0, device="cpu")
    shape = (48, 40, 24)
    vol = np.random.default_rng(0).integers(0, 255, shape).astype(np.uint8)
    run = tdp.make_chunked_pipeline(model, shape, crop=(16, 16, 8), overlap=(4, 4, 2),
                                    assign_crop=(16, 16, 8), device="cpu")
    with _VolumeAllocations(vol.size) as allocs:
        run(vol, 120.0, 60.0)
    assert allocs.count == 1
    pads = [(4, 4), (4, 4), (2, 2)]
    t = torch.from_numpy(vol)
    assert torch.equal(tdp.normalized_reflect_pad(t, 120.0, 60.0, pads, "cpu"),
                       tdp.reflect_pad((t.float() - 120.0) / 60.0, pads))
    with _VolumeAllocations(vol.size) as allocs:
        tdp.reflect_pad((t.float() - 120.0) / 60.0, pads)
    assert allocs.count == 6


def _tiny_checkpoint(path: str) -> str:
    from skoots_tpu_torch.checkpoint import save_checkpoint
    from skoots_tpu_torch.models.registry import init_model

    cfg = _tiny_cfg()
    save_checkpoint(path, cfg, init_model(cfg, 0, device="cpu").state_dict(),
                    dataset_mean=100.0, dataset_std=50.0)
    return path


def test_seam_tool_main_on_the_cpu(tmp_path, monkeypatch):
    """Both geometries and the agreement, written with the JAX tool's keys
    (a tiny random model: the tool's path, not its accuracy)."""
    monkeypatch.setenv("SKOOTS_NO_TRACEMALLOC", "1")
    ckpt = _tiny_checkpoint(str(tmp_path / "tiny.skoots"))
    out = tmp_path / "seam.json"
    assert seam_bench_agreement.main(["--ckpt", ckpt, "--shape", "96,96,32",
                                      "--n-tubes", "3", "--out", str(out),
                                      "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert {"shape", "n_tubes", "checkpoint", "geometries", "agreement_B_vs_A"} <= set(rec)
    assert rec["shape"] == [96, 96, 32] and rec["n_tubes"] >= 1
    assert set(rec["geometries"]) == set(seam_bench_agreement.GEOMETRIES)
    for row in rec["geometries"].values():
        assert row["vs_gt"]["gt_instances"] == rec["n_tubes"]
    assert "f1_at_iou50" in rec["agreement_B_vs_A"] and rec["name"] == "cpu"
    assert (tmp_path / "seam_bench_torch" / "vol.tif").exists()
