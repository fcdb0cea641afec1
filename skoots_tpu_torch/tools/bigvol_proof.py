"""Large-volume inference proof on one card (port of
``tools/bigvol_proof.py``, names kept).

    python -m skoots_tpu_torch.tools.bigvol_proof [--shape 1024,1024,1024]
        [--phantom blocks|tubes] [--n-tubes 160] [--ckpt PATH]
        [--engine auto|host|device|device-thrifty] [--device cuda]
        [--outdir runs/bigvol_torch] [--tag TAG] [--crop 192,192,96]
        [--overlap 8,8,4] [--assign-crop 256,256,64]
    python -m skoots_tpu_torch.tools.bigvol_proof --agree TAG,TAG,...

Segments a volume that is synthesized slab by slab into a disk memmap:

* ``blocks`` (the default): :func:`synthesize`'s blobby phantom, with a
  random-init ``get_cfg_defaults()`` model unless ``--ckpt`` is given;
* ``tubes``: ``seam_bench_agreement.make_tubes_big`` (seed 11), whose
  labels are kept in a memmap beside the image and score the mask
  (``vs_gt``, ``accuracy_campaign.score``).

The run is ``run_inference`` with the JAX tool's knobs (by default crop
192x192x96 with overlap 8x8x4, assignment 256x256x64 with overlap 8x8x4):
without ``--engine`` the host-streaming engine out of core (phases 2 and 3
over memmaps), with it that engine and ``out_of_core`` left to it. The
mask goes to ``<outdir>/instance[_<tag>].npy`` and the record to
``<outdir>/result[_<tag>].json``: the JAX tool's keys (``backend`` is the
card's name and power limit; ``device_memory_stats`` the allocator's peaks
over the run and what it held reserved at the start) plus the engine that
ran, ``auto``'s free bytes, tile bytes and estimates, the estimate of the
engine that ran beside the reserved peak the run added (the peak less the
reserved at the start, as ``auto`` weighs it against free memory), the
CC's rounds and convergence, and for tubes the tubes placed and
``vs_gt``. ``SKOOTS_NO_TRACEMALLOC=1`` skips allocation tracing, as in the
JAX tool. ``--agree`` scores the masks of the named tags against each
other pairwise (F1 at IoU 0.5 and mean IoU, on ``--device``) into
``<outdir>/agreement.json``.

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the kernels' plain versions (for tests at small shapes).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import resource
import sys
import threading
import time

import numpy as np

# the JAX tool's run_inference knobs
CROP = (192, 192, 96)
OVERLAP = (8, 8, 4)
ASSIGN_CROP = (256, 256, 64)
ASSIGN_OVERLAP = (8, 8, 4)
TUBES_SEED = 11


def synthesize(path: str, shape, seed: int = 0, slab: int = 64) -> None:
    """Blobby foreground phantom, written slab-wise (never whole in RAM)."""
    from skoots_tpu_torch.utils.io import open_outofcore

    rng = np.random.default_rng(seed)
    img = open_outofcore(path, shape, "uint8")
    # coarse random field -> blocky blobs when upsampled 16x; cheap enough
    # to generate at 1024^3 on one core
    cshape = tuple(max(s // 16, 1) for s in shape)
    coarse = rng.random(cshape, dtype=np.float32)
    for x0 in range(0, shape[0], slab):
        x1 = min(x0 + slab, shape[0])
        cx0, cx1 = x0 // 16, (x1 + 15) // 16
        blk = coarse[cx0:cx1]
        up = np.repeat(np.repeat(np.repeat(blk, 16, 0), 16, 1), 16, 2)
        up = up[x0 - cx0 * 16 : x0 - cx0 * 16 + (x1 - x0), : shape[1], : shape[2]]
        noise = rng.integers(0, 40, up.shape, dtype=np.uint8)
        img[x0:x1] = np.where(up > 0.75, 200, 30).astype(np.uint8) + noise
    img.flush()
    del img


class _AnonRssSampler:
    """Peak ANONYMOUS RSS, sampled from /proc/self/status.

    ``ru_maxrss`` counts resident file-backed memmap pages too — page
    cache the kernel reclaims under pressure — so on a memmap-streaming
    workload it reports ~volume-sized numbers that say nothing about real
    allocations (the JAX tool's first 1024^3 run: ru_maxrss 99 GB, of
    which 17 GB was reclaimable cache of the six output memmaps). Where the
    kernel reports no ``RssAnon`` (some sandboxed kernels), ``peak_kb`` is
    None and ``peak_vm_kb``, the peak ``VmRSS`` (file-backed pages
    included), is all there is."""

    def __init__(self, interval_s: float = 1.0):
        self.peak_kb = None
        self.peak_vm_kb = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(interval_s,),
                                   daemon=True)

    def _sample(self) -> None:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("RssAnon:"):
                        self.peak_kb = max(self.peak_kb or 0, int(line.split()[1]))
                    elif line.startswith("VmRSS:"):
                        self.peak_vm_kb = max(self.peak_vm_kb, int(line.split()[1]))
        except OSError:
            pass

    def _run(self, interval_s):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(interval_s)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        self._sample()


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def tubes_phantom(outdir: str, shape, n_tubes: int):
    """The tubes image and its labels as ``.npy`` memmaps in ``outdir``
    (``bigvol_tubes.npy``, ``bigvol_tubes_labels.npy``), made anew unless
    the sidecar ``bigvol_tubes.json`` records the same shape, tube count
    and seed. Returns (image path, labels path, tubes placed)."""
    from skoots_tpu_torch.tools.seam_bench_agreement import make_tubes_big
    from skoots_tpu_torch.utils.io import open_outofcore

    img_path = os.path.join(outdir, "bigvol_tubes.npy")
    lab_path = os.path.join(outdir, "bigvol_tubes_labels.npy")
    meta_path = os.path.join(outdir, "bigvol_tubes.json")
    want = {"shape": list(shape), "n_tubes": n_tubes, "seed": TUBES_SEED}
    meta = _read_json(meta_path)
    if (meta and {k: meta.get(k) for k in want} == want
            and os.path.exists(img_path) and os.path.exists(lab_path)):
        return img_path, lab_path, int(meta["n_placed"])
    # bbox-local tube rasterizer (O(sum tube bboxes)), into the disk labels
    labels = open_outofcore(lab_path, shape, "int32")
    img, labels, n_placed = make_tubes_big(shape, n_tubes, radius=5.0, seed=TUBES_SEED,
                                           min_separation=14.0, labels=labels)
    labels.flush()
    del labels
    out = open_outofcore(img_path, shape, "uint8")
    for x0 in range(0, shape[0], 64):
        out[x0 : x0 + 64] = img[x0 : x0 + 64]
    out.flush()
    del out, img
    with open(meta_path, "w") as f:
        json.dump({**want, "n_placed": n_placed}, f)
    print(f"tubes phantom: {n_placed} placed", flush=True)
    return img_path, lab_path, n_placed


def random_checkpoint(outdir: str, seed: int = 0) -> str:
    """The flagship default-config model at random init (the port's init
    from a ``torch.Generator`` seeded with ``seed``), written by the port's
    checkpoint writer to ``<outdir>/model.skoots``: the proof is about the
    pipeline's memory and throughput envelope, not accuracy."""
    from skoots_tpu_torch.checkpoint import save_checkpoint
    from skoots_tpu_torch.config import get_cfg_defaults
    from skoots_tpu_torch.models.registry import init_model

    ckpt = os.path.join(outdir, "model.skoots")
    cfg = get_cfg_defaults()
    model = init_model(cfg, seed, device="cpu")
    save_checkpoint(ckpt, cfg, model.state_dict(), dataset_mean=128.0,
                    dataset_std=64.0)
    return ckpt


def forward_tile_bytes(ckpt: str, shape, crop, overlap, assign_crop, device) -> int:
    """What ``auto`` measures for its estimates (``engine.
    _forward_tile_bytes``): one forward tile's reserved peak at this tool's
    geometry with the reference dilation stack; 0 off a card."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.models import model_from_checkpoint
    from skoots_tpu_torch.ops.cropper import bucketed_crop_size

    model = model_from_checkpoint(load_checkpoint(ckpt), device=device)
    tile = bucketed_crop_size(tuple(max(4, c // 4 * 4) for c in crop), shape)
    dev_crop, _, dev_assign = engine._device_geometry(shape, tile, crop, overlap,
                                                      assign_crop)
    return engine._forward_tile_bytes(model, [dev_crop, dev_assign or dev_crop],
                                      0.8, 0.8, 1, 2, device)


def _max_label(mask, shape) -> int:
    n = 0
    step = max(shape[0] // 16, 1)
    for x0 in range(0, shape[0], step):
        n = max(n, int(np.asarray(mask[x0 : x0 + step]).max()))
    return n


def prove(shape, outdir: str = "runs/bigvol_torch", phantom: str = "blocks",
          n_tubes: int = 160, ckpt: str | None = None, engine_impl: str | None = None,
          tag: str | None = None, device="cuda", crop=CROP, overlap=OVERLAP,
          assign_crop=ASSIGN_CROP) -> dict:
    """One proof run (see the module's docstring); returns the record it
    writes to ``<outdir>/result[_<tag>].json``."""
    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.device_pipeline import estimated_device_bytes
    from skoots_tpu_torch.tools.accuracy_campaign import _device_record, score
    from skoots_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    shape = tuple(int(s) for s in shape)
    os.makedirs(outdir, exist_ok=True)

    t0 = time.time()
    lab_path, n_placed = None, None
    if phantom == "blocks":
        img_path = os.path.join(outdir, "bigvol.npy")
        if not os.path.exists(img_path) or tuple(
                np.load(img_path, mmap_mode="r").shape) != shape:
            synthesize(img_path, shape)
    else:
        img_path, lab_path, n_placed = tubes_phantom(outdir, shape, n_tubes)
    synth_s = time.time() - t0

    ckpt = ckpt or random_checkpoint(outdir)
    # an explicit device engine skips auto's measurement: take it here
    tile_bytes = (forward_tile_bytes(ckpt, shape, crop, overlap, assign_crop, device)
                  if engine_impl in ("device", "device-thrifty") else None)
    reserved_at_start = 0
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reserved_at_start = torch.cuda.memory_reserved(device)

    import tracemalloc

    trace = os.environ.get("SKOOTS_NO_TRACEMALLOC", "") in ("", "0")
    baseline = 0
    if trace:
        tracemalloc.start()
        baseline = tracemalloc.get_traced_memory()[0]
    mask_path = os.path.join(outdir, f"instance_{tag}.npy" if tag else "instance.npy")
    t0 = time.time()
    with _AnonRssSampler() as rss:
        mask = engine.run_inference(
            img_path, ckpt, crop_size=tuple(crop), overlap=tuple(overlap),
            assign_crop_size=tuple(assign_crop), assign_overlap=ASSIGN_OVERLAP,
            out_of_core=None if engine_impl else True,
            engine_impl=engine_impl or "host", output_path=mask_path, device=device)
        if on_card:
            torch.cuda.synchronize(device)
    wall = time.time() - t0
    tm_peak = baseline
    if trace:
        _, tm_peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()

    stats = json.loads(json.dumps(engine.last_stats))
    ran = stats["engine"]
    dev_stats = ({"max_memory_allocated": torch.cuda.max_memory_allocated(device),
                  "max_memory_reserved": torch.cuda.max_memory_reserved(device),
                  "memory_reserved_at_start": reserved_at_start}
                 if on_card else {})
    # what the run added to the allocator's segments, the bytes 'auto'
    # weighs against the card's free memory
    reserved = dev_stats["max_memory_reserved"] - reserved_at_start if on_card else None
    auto = stats.get("auto")
    estimate = None
    if ran != "host":
        if auto is not None:
            estimate = auto["estimated_bytes"][ran]
        else:
            estimate = estimated_device_bytes(
                shape, thrifty=ran == "device-thrifty",
                itemsize=np.load(img_path, mmap_mode="r").dtype.itemsize,
                tile_bytes=tile_bytes)
    if ran == "host":
        cc_rounds = stats["phase2"]["cc_rounds"]
        cc_converged = stats["phase2"]["cc_converged"]
    else:
        cc_rounds, cc_converged = stats["cc_rounds"], stats["cc_converged"]

    vox = int(np.prod(shape, dtype=np.int64))
    rec = _device_record(device)
    result = {
        "shape": list(shape),
        "voxels": vox,
        "wall_s": round(wall, 1),
        "vox_per_s": round(vox / wall, 1),
        "synth_s": round(synth_s, 1),
        "n_instances": _max_label(mask, shape),
        "peak_anon_rss_mb": (None if rss.peak_kb is None
                             else round(rss.peak_kb / 1024, 1)),
        "peak_vm_rss_mb": round(rss.peak_vm_kb / 1024, 1),
        "peak_rss_incl_page_cache_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "tracemalloc_delta_mb": (round((tm_peak - baseline) / 1e6, 1)
                                 if trace else None),
        "device_memory_stats": dev_stats,
        "out_of_core": stats.get("out_of_core"),
        "backend": (f"{rec['name']}, {rec['power_limit']}" if on_card else "cpu"),
        "phantom": phantom,
        "checkpoint": ckpt,
        "phases": stats,
        "engine": engine_impl or "host",
        "engine_ran": ran,
        "auto": auto,
        "estimated_bytes": estimate,
        "reserved_peak_bytes": reserved,
        "reserved_within_estimate": (None if estimate is None or reserved is None
                                     else reserved <= estimate),
        "cc_rounds": cc_rounds,
        "cc_converged": cc_converged,
        "tag": tag,
        **rec,
    }
    del mask
    if lab_path is not None:
        if on_card:
            torch.cuda.empty_cache()
        result["n_placed"] = n_placed
        result["vs_gt"] = score(np.load(lab_path, mmap_mode="r"),
                                np.load(mask_path, mmap_mode="r"), device)
    name = f"result_{tag}.json" if tag else "result.json"
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    return result


def agree(outdir: str, tags, device="cuda") -> dict:
    """Pairwise agreement of the masks ``<outdir>/instance_<tag>.npy``
    (``accuracy_campaign.score`` of the second against the first), written
    to ``<outdir>/agreement.json``."""
    from skoots_tpu_torch.tools.accuracy_campaign import _device_record, score
    from skoots_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    pairs = {}
    for a, b in itertools.combinations(tags, 2):
        pairs[f"{b}_vs_{a}"] = score(
            np.load(os.path.join(outdir, f"instance_{a}.npy"), mmap_mode="r"),
            np.load(os.path.join(outdir, f"instance_{b}.npy"), mmap_mode="r"), device)
        print(json.dumps({f"{b}_vs_{a}": pairs[f"{b}_vs_{a}"]}), flush=True)
    out = {"tags": list(tags), "pairs": pairs, **_device_record(device)}
    with open(os.path.join(outdir, "agreement.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m skoots_tpu_torch.tools.bigvol_proof",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shape", default="1024,1024,1024")
    ap.add_argument("--outdir", default="runs/bigvol_torch")
    ap.add_argument("--ckpt", default=None,
                    help="use this trained checkpoint instead of a random-init "
                         "model (locally converging embedding walks)")
    ap.add_argument("--phantom", choices=("blocks", "tubes"), default="blocks",
                    help="'tubes' rasterizes bbox-local tube instances "
                         "(in-distribution for a tube-trained --ckpt)")
    ap.add_argument("--n-tubes", type=int, default=160)
    ap.add_argument("--engine", default=None,
                    choices=("auto", "host", "device", "device-thrifty"),
                    help="engine_impl override (out_of_core is then left to the "
                         "engine); default: the host engine out of core")
    ap.add_argument("--tag", default=None,
                    help="write result_<tag>.json and instance_<tag>.npy")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for tests)")
    ap.add_argument("--crop", default=",".join(map(str, CROP)))
    ap.add_argument("--overlap", default=",".join(map(str, OVERLAP)))
    ap.add_argument("--assign-crop", default=",".join(map(str, ASSIGN_CROP)))
    ap.add_argument("--agree", default=None,
                    help="comma-separated tags: score their masks pairwise "
                         "instead of running")
    args = ap.parse_args(argv)

    import logging

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(name)s [%(levelname)s]: %(message)s",
    )
    if args.agree:
        agree(args.outdir, args.agree.split(","), args.device)
        return 0
    ints = lambda v: tuple(int(i) for i in v.split(","))  # noqa: E731
    prove(ints(args.shape), args.outdir, args.phantom, args.n_tubes, args.ckpt,
          args.engine, args.tag, args.device, ints(args.crop), ints(args.overlap),
          ints(args.assign_crop))
    return 0


if __name__ == "__main__":
    sys.exit(main())
