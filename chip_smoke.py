"""Drive the PyTorch/CUDA port (``skoots_tpu_torch``) once on one GPU.

    python3 chip_smoke.py [--phases kernels,host,...]

Needs a CUDA card and ``nvcc``; exits non-zero (printing no result) without
them. ``--phases`` runs only the named phases (``PHASES``) and the phases
they need, in order, so two calls can share the work; with no argument
every phase runs. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written CUDA kernels from ``skoots_tpu_torch/csrc`` (one
   ``nvcc`` per source, all at once) and counts the tensor-core
   instructions (HMMA / HGMMA) of every instantiation of the bf16 block
   tail, depthwise conv, stem GEMMs (the 32-channel templates and the
   chunked kernels of every other width and k), LN head and the depthwise
   conv's and stems' weight gradients in the library's SASS (``cuobjdump
   -sass``; none fails);
3. compares every kernel with its plain PyTorch version on the card, at the
   shapes the main paths give it, on seeded random inputs (propagate also
   on the main path's sparse mask: one 192-pass CC round on the 512^3
   phantom's dilated skeleton), and times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call, with CUDA events (median of several runs); the
   depthwise conv, the block tail and the LN head also at the host
   engine's and the training path's shapes, ragged shapes, k = 3 and f32,
   the stems at every width and k their GEMMs take (``STEM_DWCONV_CASES``,
   ``STEM_WGRAD_CASES``: k = 9 to 15, 1 -> 8 to 256, the wide model's
   1 -> 48 tiles; each stem check asserts its route), the block tail and
   the LN head beside their plain cuBLAS compositions;
   checks the depthwise conv's bf16
   input gradient against its plain composition, and that the block
   tail's and LN head's autograd backward is exactly the autograd of their
   plain compositions;
4. the two microbenchmarks (``skoots_tpu_torch.tools.bench_fma_rate`` and
   ``bench_loadfma``), each checked against its plain version, with their
   rates;
5. host-streaming engine: ``infer.engine.run_inference`` at its defaults
   (``auto`` -> host at 256^3) on a seeded 256^3 tube phantom saved as
   ``.npy``, with the bench checkpoint ``runs/bench_ckpt.skoots`` at full
   width, every launch count set to 0 just before and read just after:
   instance count, stage split, launches against the forwards and CC rounds
   the engine ran (the plain propagation may not run); then the same with
   ``use_cached_data`` (the mask must be equal) and with ``out_of_core``
   (recompute + memmaps); then on a 128x128x32 block on the card and on the
   CPU (every kernel's plain version), compared instance by instance;
6. whole-volume path: ``infer.device_pipeline.make_chunked_pipeline`` on the
   bench checkpoint over the seeded 512^3 tube phantom rendered on the card,
   with ``bench.py``'s knobs -- launch counts set to 0 just before and read
   just after (propagate: ``len(launch_plan(192))`` a CC round, the plain
   propagation may not run); prints the phase split, the instance count
   against the number of placed tubes, the CC rounds, the launch counts and
   peak device memory;
7. runs the same pipeline on a 128x128x64 block of the phantom on the card
   and on the CPU and compares the instances;
8. device-thrifty path: ``infer.device_pipeline.make_thrifty_pipeline`` on
   the same phantom as a uint8 host array, with the same knobs (the assign
   phase runs the forward again on 256x256x64 tiles), launch counts set to
   0 just before and read just after (each forward kernel per forward of
   the pipeline's tile plan, propagate per CC round), the mask 16-bit and
   numbered 1..N, the instance count, the phase split and peak device
   memory (held against ``estimated_device_bytes`` with one forward tile's
   peak; the CC and compaction alone against its 13 B a voxel), a warm
   rerun and the chunked pipeline again; then ``skoots-validate``'s
   metrics on the card (thrifty mask against the chunked one: F1@0.5 >=
   0.95) and their IoU, Dice and clDice tables against the CPU's;
9. the sparse-checkpoint probe (``infer.engine._probe_semantic_threshold``)
   on the phantom at ``run_inference``'s 512^3 probe geometry, launch counts
   set to 0 just before and read just after, and its threshold on the card
   against the CPU's plain versions on a block three tubes cross;
10. ``infer.engine.run_inference`` on the uint8 phantom (``.npy``) with
   ``engine_impl="device-thrifty"``, then with ``auto`` while a ballast
   tensor leaves free only memory halfway between the thrifty and chunked
   estimates (``auto`` must take the thrifty pipeline and finish): launch
   counts, the phases JSON, the instance count;
11. one f32 train step of the full-width model on a 32x32x16 batch, on the
   card and on the CPU from the same weights: loss and every gradient;
12. training path (``skoots-train`` at the bench checkpoint's training cfg:
   bf16, crop 96x96x32, batch 1, on seeded synthetic tube volumes): 8 steps
   on one augmented batch (the loss must fall; the step time split into
   augment, forward + loss, backward and optimizer, and peak memory), then
   ``train.engine.train`` for 2 epochs of 8 steps through the whole
   augmentation with the launch counts set to 0 before and read after, and
   the saved checkpoint loaded back and run;
13. ground-truth skeletons: ``train.generate_skeletons.calculate_skeletons``
    with Lee thinning (host C++) on the training phase's two volumes, every
    instance with a point and >= 95% of the points in their own instance;
14. sparse training (``experimental.sparse_engine``) at the same cfg with
    ``IS_SPARSE``, on those volumes and skeletons as in-memory
    ``SparseRecord``s: 8 steps on one batch (the step split), then
    ``train_sparse`` for 2 epochs of 8 steps, the launch counts set to 0
    before and read after (exact: per step and per forward of the threshold
    calibrator), every loss finite, the ``*_sparse.skoots`` checkpoint with
    a calibrated threshold, reloaded; then ``run_inference`` with it on a
    128x128x64 block of the 256^3 phantom, printing which semantic gate won;
15. this slice's phases (Pillow is blocked for the whole run, from the
    start): after the host engine, the 256^3 phantom written as a ``.tif``
    by the port's own codec and read back (MB/s of both), then ``skoots-torch
    --image phantom.tif`` (``cli.main``), launch counts read, its ``.tif``
    mask equal to the ``.npy`` run's; after the training path, 8 steps each
    of UNeXT with DropPath 0.1 and silu, with layer scale 0, and of
    UNet3D (``bism_unet``, 32-64-128-64-32, depth 2) on one batch, the loss
    falling and the launches exact (no block tail in the plain-tail
    variants; no dwconv, wgrad or LN head in UNet3D), one f32 UNet3D step
    card vs CPU; a resume with ``LOAD_PRETRAINED_OPTIMIZER`` (moments bit
    for bit, the resumed step within 1e-2 * lr of the uninterrupted one);
    UNet3D through ``make_chunked_pipeline`` on the 512^3 phantom (2
    upsamples a tile, no dwconv), its probabilities and instances card vs
    CPU on the 128x128x64 block; the load + FMA variants' bounds come from
    their SASS (FFMA against shared-memory wavefronts a column);
16. the per-slice 2D mode, the CC variants and the mask tools' slice: after
    the sparse probe, the 512^3 bench phantom through
    ``make_chunked_pipeline`` with (a) ``cc_impl="sparse"``, (b)
    ``SKOOTS_CC_IMPL=sparse`` and (c) ``cc_scans_per_round=1``, each mask
    equal to the dense run's, (a) and (b) labelled by the engine JAX's
    rule picks from the sparse CC's points, edges and rounds (the dilated
    skeleton's edges overflow ``4 * cc_n_max``, so the dense CC), (c)
    ``len(launch_plan(192))`` propagate launches a round; (d) without the
    skeleton's dilation, sparse against dense: the sparse CC labels it, no
    propagate launch; ``2-cc`` and the rounds printed; the thrifty
    pipeline under ``SKOOTS_CC_IMPL=sparse`` (dense CC, its default mask);
    at the end, on the 256^3 host phantom, ``run_perslice_inference`` from
    scratch (phase 1 with the host cell's launches) and on its cached
    buffers (the masks equal; the assign and stitch seconds), its
    ``perslice_segment`` on the card against the CPU's voxel for voxel,
    propagate against its plain version at the per-slice layout
    ``[2Z - 1, X, Y]``, the host engine with ``use_cached_data`` under
    ``SKOOTS_CC_IMPL=sparse`` (mask equal to the default one; tiles per CC
    engine), and the oracle on the accuracy campaign's aniso val phantom
    (``make_tubes((192, 192, 32), 24, radius=4, seed=999,
    min_separation=10)``: the bake kernel against its plain version on the
    phantom's labels and packed skeletons, exact; ``perfect_prediction``
    with one bake launch counted; ``perslice_segment`` at scale (12, 12,
    6), N = 10): 21 of 21 at IoU 0.5;
17. the widths and kernel sizes slice and the accuracy campaign: the kernel
    checks of 3 also run at the campaign model's shapes (widths 16-32-64 at
    its training crop and its 128x128x32 and 192x192x32 inference tiles:
    the tensor-core templates at C = 16), at every other width the JAX
    kernels take (ragged V at C = 8, 24, 48, 96, 256; the LN head to N =
    256: the run-time-width kernels) and at k = 9 and 11 (the run-time-k
    forward and weight gradient), each beside its plain version, cuDNN or
    the cuBLAS composition; last, the campaign's ``separated`` scenario at
    the tool's defaults (150 epochs of 10 steps) through
    ``skoots_tpu_torch/tools/accuracy_campaign.py::run_scenario``: every
    kernel of its training and inference counted exactly (the plain
    propagation barred), F1 at IoU 0.5 >= 0.8; then propagate against its
    plain version on the run's validation skeleton, every CC round of it
    (0 voxels differing);
18. multi-device inference and training over meshes that repeat this one
    card (the port's meshes may name a device more than once): after the
    thrifty engine, ``run_sharded`` (the sharded pipeline on a 254x256x256
    phantom at 1, 2 and 4 slabs, launches exact, the forward against 1
    slab, the CC and walk exactly 1 slab's for both gathers and walks,
    the reserved peak within the estimate also on the phantom's first 126
    planes, every kernel against its plain version at every operand shape
    the sharded runs gave it (whole 256^3 levels, slabs with their halos,
    the CC's halo'd chunks), ``run_inference``'s shard resolution on one
    card); after the resume,
    ``run_dp_train`` (a data-2 step against the one-device step, 8 bf16
    steps with exact launches, NCCL at world size 1);
19. the single-program pipeline (``make_device_pipeline``) right after the
   host engine, at JAX's defaults (crop 256x256x16, overlap 16x16x2, CC
   32 x 128 propagates and 1 jump) on the 256^3 host phantom with the
   bench checkpoint: launches exact (each forward kernel per tile,
   propagate per CC round), the instances inside the phantom's bar, the
   warm e2e (median of 3), phase split and reserved peak; the host
   engine's block card vs CPU; every kernel against its plain version at
   the operand shapes of the run (levels of Z = 16, 8, 4);
   ``segment_volume_chunked`` against the chunked pipeline it wraps; a
   ``.trch`` round trip (the checkpoint exported to the reference twin's
   ``state_dict`` layout, ``torch.save``d with a dict cfg, converted back
   by ``utils/torch_compat.py::convert_trch``: parameters bit for bit, the
   same mask);
20. the scale slice, ``run_scale`` right after the thrifty engine: the
    scale tool (``skoots_tpu_torch.tools.bigvol_proof.prove``) in process
    at 512x512x256 on a ``make_tubes_big`` phantom with the bench
    checkpoint and the JAX tool's geometry, with ``auto`` (it must take
    the chunked pipeline, its reserved peak at or under the estimate ``auto``
    used, the CC converged) and with the host engine out of core, then
    ``run_inference`` in RAM: the out-of-core mask the in-RAM one's up to
    the numbering (their CC tiles differ), ``auto`` against the host engine
    at F1@0.5 >= 0.95, every count in the phantom's band, launches exact;
    every kernel against its plain version at the ``auto`` run's operand
    shapes;
21. the wide slice, ``run_wide`` right after 7: the 1.5x-wide UNeXT3D
    (``MODEL.DIMS`` 48-96-192-96-48, depth 2, 48 outputs, random weights
    from the seed, saved under ``build/``) through ``make_chunked_pipeline``
    on the 512^3 phantom at the bench knobs: launches exact, every block
    tail and LN head launch on a width-class or staged kernel (the route
    query), each against its plain version at the run's operand shapes,
    ``1-forward`` cold and warm beside the bench model's, one tile's
    prob > 0.8 decisions kernels vs plain versions on the card (the share
    equal printed beside the bench model's; every voxel farther than
    ``DECISION_MARGIN`` from 0.8 alike), one f32 train step card vs CPU at
    those widths; the kernel
    checks of 3 also at its shapes (``WIDE_TAIL_CASES``,
    ``WIDE_LN_HEAD_CASES``), and every tail and LN-head check asserts its
    route; the stem, the depthwise convs and the upsamples against their
    plain versions at the run's operand shapes; one bf16 training step of
    the wide model at the bench training cfg (median of 5, launches exact);
    the stems' launches on the bench, wide and campaign paths (inference
    and training) each on the GEMM the path's width takes (``_stem_routes``
    at the library's entry points; over the whole run, every bf16 stem the
    GEMMs take on one);
22. last, the JAX repo's last four user tools as the port runs them
    (``run_tools``): ``skeleton_quality`` on the host; ``calibrate_sparse_ckpt``
    on a copy of 14's checkpoint and its volumes written as a training
    directory (launches exact, the parameters, optimizer state and other
    ``extra`` keys unchanged, the threshold beside the save-time one);
    ``score_checkpoint`` on 17's separated checkpoint (launches exact, F1 at
    IoU 0.5 >= 0.8 and mean IoU >= 0.7); ``convergence`` at 2 epochs of 2
    steps through the real CLIs, every training and inference launch
    counted exactly;
23. prints one JSON line of per-kernel results (each with its least time on
    the card, ``bound_ms``, from the bytes it must move at 3.35 TB/s and its
    operations at the published peak of their type), and last the
    ``{"ok": true, ...}`` device line.

Before the kernels it reads the bench training cfg with the port's own YAML
reader (no PyYAML); after the host engine it runs ``skoots-torch
--experimental`` (``cli.main``) on the 256^3 phantom, launch counts read,
with the tuned knobs printed and the instance count beside the default
run's; the kernel checks include the bake at the sparse loss's shape. The
training kernels' cases and every row's bound come from
``skoots_tpu_torch.tools.bench_train_kernels``, so this script, that tool
and the card's tests check the same inputs.

Every phase raises on failure; nothing here catches it. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

# one roofline and one set of training-kernel cases with the card's tool
from skoots_tpu_torch.tools.bench_tail_head import head_ops, tail_ops
from skoots_tpu_torch.tools.bench_train_kernels import (ANISO, bake_bound, bake_cases, bound,
                                                        nbytes, wgrad_bound, wgrad_inputs)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# main path: bench.py geometry (256^2 x 96 forward tiles, no overlap), the
# bench checkpoint's UNeXT widths 32-64-128 and a 512^3 volume
TILE = (256, 256, 96)
VOLUME = (512, 512, 512)
# training path: the bench checkpoint's training crop
TRAIN_CROP = (96, 96, 32)
# host-streaming path: a 256^3 volume (auto picks the host engine up to 256^3)
HOST_VOLUME = (256, 256, 256)
# the thrifty pipeline's assign tile, where it runs the forward again
ASSIGN_TILE = (256, 256, 64)
# the sparse-checkpoint probe's tile geometry: run_inference's for a 512^3
# volume at the CLI defaults (crop 300x300x20, overlap 50x50x5); the card
# is held against the CPU's plain versions on the 128x128x64 block of the
# phantom that three tubes cross, as two 128x128x32 tiles (the full-width
# model takes 10-15 us a voxel on that machine's CPU)
PROBE_TILE, PROBE_OVERLAP = (300, 300, 20), (50, 50, 5)
PROBE_CPU_TILE = (128, 128, 32)
PROBE_CPU_BLOCK = (slice(192, 320), slice(192, 320), slice(192, 256))
# the upsample's inputs: the two decoder stages of the bench tile, of the
# host engine's 256x256x20 tile, of the training crop at batch 2, of the
# thrifty assign tile and of the probe tile
UPSAMPLE_SHAPES = ((1, 64, 64, 24, 128), (1, 128, 128, 48, 64), (1, 64, 64, 5, 128),
                   (1, 128, 128, 10, 64), (2, 24, 24, 8, 128), (2, 48, 48, 16, 64),
                   (1, 64, 64, 16, 128), (1, 128, 128, 32, 64), (1, 75, 75, 5, 128),
                   (1, 150, 150, 10, 64))
# the depthwise conv at every shape the paths give it: ([B, X, Y, Z],
# input channels, output channels, k, dtype): the bench tile's four levels,
# the thrifty assign tile's and the probe tile's, the host engine's
# 256x256x20 tile, the training crop's, then k = 3 at batch 2 on ragged X,
# Y, Z, and one f32 shape (the FP32 kernel)
DWCONV_CASES = (
    ((1, 256, 256, 96), 1, 32, 7, "bf16"), ((1, 256, 256, 96), 32, 32, 7, "bf16"),
    ((1, 128, 128, 48), 64, 64, 7, "bf16"), ((1, 64, 64, 24), 128, 128, 7, "bf16"),
    ((1, 256, 256, 64), 1, 32, 7, "bf16"), ((1, 256, 256, 64), 32, 32, 7, "bf16"),
    ((1, 128, 128, 32), 64, 64, 7, "bf16"), ((1, 64, 64, 16), 128, 128, 7, "bf16"),
    ((1, 300, 300, 20), 1, 32, 7, "bf16"), ((1, 300, 300, 20), 32, 32, 7, "bf16"),
    ((1, 150, 150, 10), 64, 64, 7, "bf16"), ((1, 75, 75, 5), 128, 128, 7, "bf16"),
    ((1, 256, 256, 20), 1, 32, 7, "bf16"), ((1, 256, 256, 20), 32, 32, 7, "bf16"),
    ((1, 128, 128, 10), 64, 64, 7, "bf16"), ((1, 64, 64, 5), 128, 128, 7, "bf16"),
    ((1, 96, 96, 32), 1, 32, 7, "bf16"), ((1, 96, 96, 32), 32, 32, 7, "bf16"),
    ((1, 48, 48, 16), 64, 64, 7, "bf16"), ((1, 24, 24, 8), 128, 128, 7, "bf16"),
    ((2, 40, 36, 20), 32, 32, 3, "bf16"), ((1, 48, 48, 16), 64, 64, 7, "f32"),
)
# the block tail: (V, C, dtype) for the same paths' levels, then V that no
# row tile divides (128 rows a block at C = 32 and 64, 64 at 128) and one
# f32 shape (the FP32 kernel)
TAIL_CASES = (
    (256 * 256 * 96, 32, "bf16"), (128 * 128 * 48, 64, "bf16"), (64 * 64 * 24, 128, "bf16"),
    (256 * 256 * 64, 32, "bf16"), (128 * 128 * 32, 64, "bf16"), (64 * 64 * 16, 128, "bf16"),
    (300 * 300 * 20, 32, "bf16"), (150 * 150 * 10, 64, "bf16"), (75 * 75 * 5, 128, "bf16"),
    (256 * 256 * 20, 32, "bf16"), (128 * 128 * 10, 64, "bf16"), (64 * 64 * 5, 128, "bf16"),
    (96 * 96 * 32, 32, "bf16"), (48 * 48 * 16, 64, "bf16"), (24 * 24 * 8, 128, "bf16"),
    (100003, 32, "bf16"), (12347, 64, "bf16"), (3001, 128, "bf16"), (4173, 64, "f32"),
)
# the LN head: (V, C, N, dtype) at the paths' shapes (the bench tile, the
# thrifty assign tile, the probe tile, the host engine's tile, the training
# crop), then V that no 32-row warp tile divides, N = 8, C = 64, C = N =
# 128 (W in shared memory) and one f32 shape (the FP32 kernel)
LN_HEAD_CASES = (
    (256 * 256 * 96, 32, 32, "bf16"), (256 * 256 * 64, 32, 32, "bf16"),
    (300 * 300 * 20, 32, 32, "bf16"), (256 * 256 * 20, 32, 32, "bf16"),
    (96 * 96 * 32, 32, 32, "bf16"), (100003, 32, 32, "bf16"), (100003, 32, 8, "bf16"),
    (12347, 64, 32, "bf16"), (3001, 128, 128, "bf16"), (4173, 32, 32, "f32"),
)
# the accuracy campaign's model (tools/accuracy_campaign.py: widths
# 16-32-64-32-16, depth 1, k 7, 16 output channels) at its training crop
# (96x96x32, batch 1) and its two inference tiles (128x128x32 and
# 192x192x32), each at its three levels; then every width the JAX kernels
# take beyond the templates' (ragged V at C = 8, 24, 48, 96, 256; the LN
# head to N = 256), and k = 9 and 11 (the run-time-k kernels), bf16 and f32.
# Their inputs come from a generator of their own, so the cases above keep
# theirs.
CAMPAIGN_LEVELS = (((96, 96, 32), 16), ((48, 48, 16), 32), ((24, 24, 8), 64),
                   ((128, 128, 32), 16), ((64, 64, 16), 32), ((32, 32, 8), 64),
                   ((192, 192, 32), 16), ((96, 96, 16), 32), ((48, 48, 8), 64))
CAMPAIGN_DWCONV_CASES = tuple(
    case for (x, y, z), c in CAMPAIGN_LEVELS
    for case in ((((1, x, y, z), 1, 16, 7, "bf16"),) if c == 16 else ())
    + (((1, x, y, z), c, c, 7, "bf16"),)) + (
    ((1, 96, 96, 32), 16, 16, 9, "bf16"), ((1, 96, 96, 32), 1, 16, 9, "bf16"),
    ((1, 48, 48, 16), 32, 32, 11, "bf16"), ((2, 40, 36, 20), 32, 32, 9, "f32"),
    ((1, 24, 24, 8), 64, 64, 11, "f32"))
CAMPAIGN_TAIL_CASES = tuple((x * y * z, c, "bf16") for (x, y, z), c in CAMPAIGN_LEVELS) + (
    (12347, 16, "bf16"), (100003, 8, "bf16"), (30011, 24, "bf16"), (30011, 48, "bf16"),
    (7777, 96, "bf16"), (4099, 256, "bf16"), (4173, 16, "f32"), (4173, 24, "f32"),
    (4173, 256, "f32"))
CAMPAIGN_LN_HEAD_CASES = (
    (96 * 96 * 32, 16, 16, "bf16"), (128 * 128 * 32, 16, 16, "bf16"),
    (192 * 192 * 32, 16, 16, "bf16"), (100003, 8, 8, "bf16"), (30011, 24, 24, "bf16"),
    (30011, 48, 200, "bf16"), (12347, 16, 130, "bf16"), (4099, 256, 256, "bf16"),
    (4099, 32, 256, "bf16"), (4173, 16, 16, "f32"), (4173, 256, 256, "f32"))
# the campaign model's decoder upsamples: [B, X, Y, Z, C] at the training
# crop and the two inference tiles
CAMPAIGN_UPSAMPLE_SHAPES = ((1, 24, 24, 8, 64), (1, 48, 48, 16, 32), (1, 32, 32, 8, 64),
                            (1, 64, 64, 16, 32), (1, 48, 48, 8, 64), (1, 96, 96, 16, 32))
# the weight gradient at the campaign's training levels (the stem 1 -> 16 and
# the three widths) and at k = 9 and 11: ([B, X, Y, Z], Cin, C, k, dtype)
CAMPAIGN_WGRAD_CASES = (
    ((1, 96, 96, 32), 1, 16, 7, "bf16"), ((1, 96, 96, 32), 16, 16, 7, "bf16"),
    ((1, 48, 48, 16), 32, 32, 7, "bf16"), ((1, 24, 24, 8), 64, 64, 7, "bf16"),
    ((1, 96, 96, 32), 16, 16, 9, "bf16"), ((1, 96, 96, 32), 1, 16, 9, "bf16"),
    ((1, 48, 48, 16), 32, 32, 11, "bf16"), ((2, 24, 20, 12), 32, 32, 9, "f32"))
# the bf16 depthwise layers the big-k kernels do not take, which stay on the
# run-time-k kernels (dwconv3d_any_kernel<bf16>, dwconv3d_wgrad_any_kernel<bf16>):
# C off 8 at k = 9 and 11, and k = 17; forward and weight gradient, drawn on
# the card from a generator of their own. ([B, X, Y, Z], Cin, C, k, dtype)
RUNTIME_K_CASES = (
    ((1, 48, 48, 16), 12, 12, 9, "bf16"), ((1, 48, 48, 16), 20, 20, 11, "bf16"),
    ((1, 40, 36, 20), 16, 16, 17, "bf16"))
# the stems' GEMMs at every width and k (csrc/dwconv.cu::stem_gemm_chunk_kernel,
# csrc/dwconv_wgrad.cu::stem_wgrad_chunk_kernel; the 1 -> 16 k = 9 stem is a
# campaign case above): k = 9 and 11 at 1 -> 16 and 1 -> 48 on the training
# crop, 256 channels on a ragged batch, k = 13 and 15 narrow, then the wide
# model's stem (1 -> 48) at its two inference tiles and its training crop
# (forward), and at its training crop (weight gradient); drawn on the card
# from a generator of their own. ([B, X, Y, Z], Cin, C, k, dtype)
STEM_DWCONV_CASES = (
    ((1, 96, 96, 32), 1, 16, 11, "bf16"), ((1, 96, 96, 32), 1, 48, 9, "bf16"),
    ((1, 96, 96, 32), 1, 48, 11, "bf16"), ((2, 37, 41, 29), 1, 256, 7, "bf16"),
    ((2, 37, 41, 29), 1, 256, 11, "bf16"), ((1, 40, 36, 20), 1, 24, 13, "bf16"),
    ((1, 40, 36, 20), 1, 8, 15, "bf16"), ((1, 256, 256, 96), 1, 48, 7, "bf16"),
    ((1, 256, 256, 64), 1, 48, 7, "bf16"), ((1, 96, 96, 32), 1, 48, 7, "bf16"))
STEM_WGRAD_CASES = (
    ((1, 96, 96, 32), 1, 16, 11, "bf16"), ((1, 96, 96, 32), 1, 48, 9, "bf16"),
    ((1, 96, 96, 32), 1, 48, 11, "bf16"), ((2, 37, 41, 29), 1, 256, 7, "bf16"),
    ((2, 37, 41, 29), 1, 256, 11, "bf16"), ((1, 40, 36, 20), 1, 24, 13, "bf16"),
    ((1, 40, 36, 20), 1, 8, 15, "bf16"), ((1, 96, 96, 32), 1, 48, 7, "bf16"))
# the routes each path's stem launches take: the bench model (1 -> 32, the
# 32-channel templates), the campaign model (1 -> 16) and the wide model
# (1 -> 48), k = 7
BENCH_STEM_ROUTES = {"forward": "stem_gemm_kernel<7>", "wgrad": "stem_wgrad_tc_kernel<7>"}
CAMPAIGN_STEM_ROUTES = {"forward": "stem_gemm_chunk_kernel<7,2>",
                        "wgrad": "stem_wgrad_chunk_kernel<2,1>"}
WIDE_STEM_ROUTES = {"forward": "stem_gemm_chunk_kernel<7,6>",
                    "wgrad": "stem_wgrad_chunk_kernel<6,1>"}
# the 1.5x-wide UNeXT3D of run_wide (the bench checkpoint's cfg otherwise,
# random weights from SEED): every block tail runs at C = 48, 96 or 192 and
# the LN head at 48 -> 48, off the tensor-core templates' widths
WIDE_MODEL = {"DIMS": [48, 96, 192, 96, 48], "DEPTHS": [2, 2, 2, 2, 2], "KERNEL_SIZE": 7,
              "OUT_CHANNELS": 48}
# its block tails and LN head at the bench tile's three levels and at the
# thrifty assign tile's (V, C, dtype) / (V, C, N, dtype); drawn on the card
# from a generator of their own
WIDE_TAIL_CASES = tuple((x * y * z, c, "bf16") for (x, y, z), c in (
    ((256, 256, 96), 48), ((128, 128, 48), 96), ((64, 64, 24), 192),
    ((256, 256, 64), 48), ((128, 128, 32), 96), ((64, 64, 16), 192)))
WIDE_LN_HEAD_CASES = ((256 * 256 * 96, 48, 48, "bf16"), (256 * 256 * 64, 48, 48, "bf16"))
# run_wide's decisions: a voxel whose plain probability lies farther than
# this from 0.8 (8 bf16 ulps there) must decide alike with the kernels. The
# random-weight wide model puts 2% of a tile within a bf16 ulp of 0.8,
# where any kernel's last-bit difference (the dwconv's alone, as much as
# all four) flips 0.3-0.4% of the decisions
DECISION_MARGIN = 2.0 ** -5
REPEATS = 5
# sparse training (the bench training cfg, IS_SPARSE): steps an epoch of its
# 2 epochs, the background's least distance from a tube, the points of its
# bake (the cfg's MAX_SKELETON_POINTS), and the block of the 256^3 host
# phantom its checkpoint segments
SPARSE_STEPS, SPARSE_BG_DIST, SPARSE_BAKE_POINTS = 8, 6, 256
SPARSE_BLOCK = (slice(64, 192), slice(64, 192), slice(96, 160))
# launches of each forward kernel in one forward of the bench model
FORWARD_KERNELS_PER_TILE = {"dwconv3d": 11, "mlp_block_tail": 10, "ln_head": 1,
                            "upsample2x": 2}
# the hand-written kernels that must run on the tensor cores (bf16)
TENSOR_CORE_KERNELS = ("tail_tc_kernel", "tail_class_kernel", "tail_staged_kernel",
                       "dwconv3d_tc_kernel", "dwconv3d_big_kernel", "stem_gemm_kernel",
                       "stem_gemm_chunk_kernel", "ln_head_tc_kernel", "ln_head_class_kernel",
                       "dwconv3d_wgrad_tc_kernel", "dwconv3d_wgrad_big_kernel",
                       "stem_wgrad_tc_kernel", "stem_wgrad_chunk_kernel")
# run_kernel_sizes: the bench checkpoint's cfg with MODEL.KERNEL_SIZE set to
# each of these (random weights from SEED); every bf16 depthwise launch of
# their runs takes the big-k kernels
KERNEL_SIZES = (9, 11)


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def bf16_ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of max(|ref|, rms(ref)): values below
    the tensor's RMS come from cancellation between operands of about that
    size, whose rounding error is an ulp at that size."""
    import torch

    r = ref.float().abs()
    scale = torch.maximum(r, r.square().mean().sqrt())
    _, e = torch.frexp(scale)  # scale = f * 2^e, f in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(((got.float() - ref.float()).abs() / ulp).max())


def _time_ms(fn, repeats: int = REPEATS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _randn(rng, shape, scale=1.0, dtype=None, device="cuda"):
    """Standard normal values times ``scale``: from a numpy generator on
    the host, or from a ``torch.Generator`` on its own device (the large
    cases, whose host draw would take seconds)."""
    import torch

    if isinstance(rng, torch.Generator):
        t = torch.randn(shape, generator=rng, device=rng.device) * scale
    else:
        t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        t = t.to(device)
    return t.to(dtype) if dtype is not None else t


def tensor_core_sass(lib_path) -> dict:
    """HMMA / HGMMA instructions of each tensor-core kernel instantiation in
    the built library (``cuobjdump -sass``); raises where one has none."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(%s)I((?:L[ib]\d+E)+)E" % "|".join(TENSOR_CORE_KERNELS), line)
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m else ""
            name = f"{m.group(1)}<{args}>" if m else None
            if name:
                counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    for kernel in TENSOR_CORE_KERNELS:
        found = {k: v for k, v in counts.items() if k.startswith(kernel + "<")}
        _need(bool(found) and all(v > 0 for v in found.values()),
              f"{kernel}: no tensor-core instructions in the SASS ({found})")
    return counts


def _record(results, name, source, replaces, err, err_abs, tol, unit, ms,
            plain_ms, least, library_ms=None, note=""):
    """Print one kernel-vs-plain comparison, fail above ``tol``, and sum it
    into the kernel's entry of ``results`` (times and bounds add up over
    the shapes checked; ``bound_by`` is the largest shape's)."""
    ok = err <= tol
    lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
    print(f"kernel {name}: max err {err:.6g} {unit} (bound {tol:g}) "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms{lib} "
          f"least {least[0]:.4f} ms ({least[1]}){note} {'ok' if ok else 'FAIL'}", flush=True)
    _need(ok, f"{name}: error {err} {unit} above bound {tol}")
    for r in results:
        if r["name"] == name:
            r["max_abs_err"] = max(r["max_abs_err"], err_abs)
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            if least[0] > r["_largest"]:
                r["_largest"], r["bound_by"] = least
            r["bound_ms"] += least[0]
            if library_ms is not None:
                r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
            return
    results.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": 0,
                    "max_abs_err": err_abs, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": least[0], "bound_by": least[1],
                    "library_ms": library_ms, "_largest": least[0]})


def _check_dwconv(results, r, shape, cin, c, k, dtn, repeats=REPEATS) -> None:
    """The depthwise conv at ``shape`` ([B, X, Y, Z]), ``cin`` -> ``c``
    channels, ``k``, ``dtn`` on inputs from ``r``: bf16 within 1 bf16 ulp
    of max(|plain|, rms(plain)), f32 within 1e-5 of max|plain| (f32 sums
    of the same products in another order). Least work: bf16 taps on the
    tensor cores (each product of two bf16 values is exact in f32), f32
    taps on the FP32 pipe. Library call: cuDNN's conv3d on the
    channels-last view (grouped per channel; the stem a dense 1 -> C). A
    bf16 stem the GEMMs take must route to one (the route query)."""
    import torch
    import torch.nn.functional as F

    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref, dwconv3d_route

    bf = torch.bfloat16
    dt = bf if dtn == "bf16" else torch.float32
    route = dwconv3d_route(dt, 1 if cin == c else 0, c, k)
    if _gemm_stem(dt, cin, c, k):
        _need(route.startswith(("stem_gemm_kernel<", "stem_gemm_chunk_kernel<")),
              f"dwconv3d: the stem 1 -> {c} k={k} routes to {route}")
    if _big_k(dt, cin, c, k):
        _need(route == f"dwconv3d_big_kernel<{k}>", f"dwconv3d: C={c} k={k} routes to {route}")
    elif _runtime_k(dt, cin, c, k):
        _need(route == "dwconv3d_any_kernel<bf16>", f"dwconv3d: C={c} k={k} routes to {route}")
    x = _randn(r, (*shape, cin), dtype=dt)
    w = _randn(r, (k, k, k, c), 1 / np.sqrt(k ** 3)).to(dt).float()
    b = _randn(r, (c,), 0.1).to(dt).float()
    got = dwconv3d(x, w, b)
    ref = dwconv3d_ref(x, w, b)
    torch.cuda.synchronize()
    err_abs = float((got.float() - ref.float()).abs().max())
    if dt == bf:
        err, tol, unit = bf16_ulps(got, ref), 1.0, "bf16 ulp"
        ops = {"tensor_flops": 2.0 * k ** 3 * got.numel()}
    else:
        err, tol, unit = err_abs / float(ref.abs().max()), 1e-5, "of max|plain|"
        ops = {"fp32_flops": 2.0 * k ** 3 * got.numel()}
    del ref
    xv = x.permute(0, 4, 1, 2, 3)
    wl = w.permute(3, 0, 1, 2).unsqueeze(1).to(dt).contiguous()
    bl = b.to(dt)
    groups = 1 if cin == 1 else c
    _record(results, "dwconv3d", "skoots_tpu_torch/csrc/dwconv.cu",
            "skoots_tpu/kernels/dwconv.py:334", err, err_abs, tol,
            f"{unit} at {tuple(x.shape)}->{c} k={k} {dtn} [{route}]",
            _time_ms(lambda: dwconv3d(x, w, b), repeats),
            _time_ms(lambda: dwconv3d_ref(x, w, b), repeats),
            bound(nbytes(x, w, b, got), **ops),
            _time_ms(lambda: F.conv3d(xv, wl, bl, padding=k // 2, groups=groups), repeats))


def _big_k(dt, cin: int, c: int, k: int) -> bool:
    """Whether a depthwise launch takes the big-k tensor-core kernels
    (bf16, C % 8 == 0, k = 9 ... 15)."""
    import torch

    return dt == torch.bfloat16 and cin == c and c % 8 == 0 and 9 <= k <= 15


def _runtime_k(dt, cin: int, c: int, k: int) -> bool:
    """Whether a bf16 depthwise launch at k > 7 stays on the run-time-k
    kernels (C off 8, or k > 15)."""
    import torch

    return dt == torch.bfloat16 and cin == c and k > 7 and not _big_k(dt, cin, c, k)


def _gemm_stem(dt, cin: int, c: int, k: int) -> bool:
    """Whether the stems' tensor-core GEMMs take this dense 1 -> ``c`` conv
    (bf16, C % 8 == 0, 8 <= C <= 256, k <= 15)."""
    import torch

    return dt == torch.bfloat16 and cin == 1 and c % 8 == 0 and 8 <= c <= 256 and k <= 15


def _check_wgrad(results, r, shape, cin, c, k, dtn, what, repeats=REPEATS) -> None:
    """The weight gradient at ``shape`` ([B, X, Y, Z]), ``cin`` -> ``c``, ``k``,
    ``dtn`` on inputs from ``r`` (the cotangent at 1e-3): within 1e-3 *
    max|plain| (f32 sums of the same exact products in another order), the
    same from run to run (fixed-order sums), a bf16 stem the GEMMs take on
    one (the route query); library call cuDNN's ``conv3d_weight``."""
    import torch

    from skoots_tpu_torch.kernels.dwconv import (dwconv3d_wgrad, dwconv3d_wgrad_ref,
                                                 dwconv3d_wgrad_route)

    dt = torch.bfloat16 if dtn == "bf16" else torch.float32
    route = dwconv3d_wgrad_route(dt, 1 if cin == c else 0, c, k)
    if _gemm_stem(dt, cin, c, k):
        _need(route.startswith(("stem_wgrad_tc_kernel<", "stem_wgrad_chunk_kernel<")),
              f"dwconv3d_wgrad: the stem 1 -> {c} k={k} routes to {route}")
    if _big_k(dt, cin, c, k):
        _need(route == f"dwconv3d_wgrad_big_kernel<{k}>",
              f"dwconv3d_wgrad: C={c} k={k} routes to {route}")
    elif _runtime_k(dt, cin, c, k):
        _need(route == "dwconv3d_wgrad_any_kernel<bf16>",
              f"dwconv3d_wgrad: C={c} k={k} routes to {route}")
    x = _randn(r, (*shape, cin), dtype=dt)
    g = _randn(r, (*shape, c), 1e-3, dtype=dt)
    got = dwconv3d_wgrad(x, g, k)
    ref = dwconv3d_wgrad_ref(x, g, k)
    torch.cuda.synchronize()
    _need(torch.equal(got, dwconv3d_wgrad(x, g, k)),
          f"dwconv3d_wgrad {shape} k={k}: differs run to run")
    err_abs = float((got - ref).abs().max())
    xv, gv = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        library = _time_ms(lambda: torch.nn.grad.conv3d_weight(
            xv, (c, 1, k, k, k), gv, padding=k // 2, groups=1 if cin == 1 else c), repeats)
    _record(results, "dwconv3d_wgrad", "skoots_tpu_torch/csrc/dwconv_wgrad.cu",
            "skoots_tpu/kernels/dwconv.py:782", err_abs / float(ref.abs().max()),
            err_abs, 1e-3, f"of max|plain| at {what} {shape} {cin}->{c} k={k} {dtn} [{route}]",
            _time_ms(lambda: dwconv3d_wgrad(x, g, k), repeats),
            _time_ms(lambda: dwconv3d_wgrad_ref(x, g, k), repeats),
            wgrad_bound(x, g, got), library)


def _check_tail(results, r, v, c, dtn, repeats=REPEATS) -> None:
    """The fused block tail at ``v`` rows of ``c`` channels; bound atol
    4e-3, rtol 1e-3. Least work: the bytes, the two products on the
    tensor cores, and the LayerNorm, GELU and roundings on the FP32 pipe
    (``tools/bench_tail_head.py::tail_ops``). The plain composition xla_tail (two cuBLAS GEMMs and
    elementwise kernels) is timed as a yardstick: no single library call
    computes the function, so the JSON line's library_ms stays null."""
    import torch

    from skoots_tpu_torch.kernels.mlp import (TAIL_KERNELS, mlp_block_tail, mlp_block_tail_ref,
                                              mlp_tail_route, xla_tail)

    bf = torch.bfloat16
    dt = bf if dtn == "bf16" else torch.float32
    route = mlp_tail_route(dt, c)
    _need(route is not None and route.startswith(TAIL_KERNELS),
          f"mlp_block_tail: C={c} {dtn} routes to {route}")
    x = _randn(r, (v, c), dtype=dt)
    s = _randn(r, (v, c), 0.1, dtype=dt)
    ls = _randn(r, (c,), 0.1) + 1.0
    lb = _randn(r, (c,), 0.1)
    w1 = _randn(r, (c, 4 * c), 1 / np.sqrt(c), dtype=dt)
    b1 = _randn(r, (4 * c,), 0.1)
    w2 = _randn(r, (4 * c, c), 1 / np.sqrt(4 * c), dtype=dt)
    b2 = _randn(r, (c,), 0.1)
    g = torch.full((c,), 0.1, device="cuda")
    args = (x, s, ls, lb, w1, b1, w2, b2, g)
    got = mlp_block_tail(*args)
    ref = mlp_block_tail_ref(*args)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    err_abs = float(diff.max())
    excess = float((diff - 1e-3 * ref.float().abs()).max())
    del diff, ref
    comp_ms = _time_ms(lambda: xla_tail(*args), repeats)
    _record(results, "mlp_block_tail", "skoots_tpu_torch/csrc/mlp.cu",
            "skoots_tpu/kernels/mlp.py:99", excess, err_abs, 4e-3,
            f"(|d| - 1e-3|ref|) at V={v} C={c} {dtn} [{route}]",
            _time_ms(lambda: mlp_block_tail(*args), repeats),
            _time_ms(lambda: mlp_block_tail_ref(*args), repeats),
            bound(nbytes(*args, got), **tail_ops(v, c, dtn)),
            note=f" composition {comp_ms:.3f} ms")


def _check_ln_head(results, r, v, c, n, dtn, repeats=REPEATS) -> None:
    """The fused final LN + 1x1 head at ``v`` rows, ``c`` -> ``n``: equal
    to the plain version (bf16: the tensor cores' sums whose rounding their
    order could change are recomputed in the plain order; f32: the plain
    order). Least work: the bytes, the products on the tensor cores (bf16)
    or the FP32 pipe (f32), and the LayerNorm on the FP32 pipe
    (``head_ops``). The plain composition xla_ln_head (a cuBLAS GEMM
    and elementwise kernels) is timed as a yardstick: no single library
    call computes the function, so the JSON line's library_ms stays null."""
    import torch

    from skoots_tpu_torch.kernels.lnhead import (HEAD_KERNELS, ln_head, ln_head_ref,
                                                 ln_head_route, xla_ln_head)

    bf = torch.bfloat16
    dt = bf if dtn == "bf16" else torch.float32
    route = ln_head_route(dt, c, n)
    _need(route is not None and route.startswith(HEAD_KERNELS),
          f"ln_head: C={c} N={n} {dtn} routes to {route}")
    x = _randn(r, (v, c), dtype=dt)
    ls = _randn(r, (c,), 0.1) + 1.0
    lb = _randn(r, (c,), 0.1)
    w = _randn(r, (c, n), 1 / np.sqrt(c), dtype=dt)
    b = _randn(r, (n,), 0.1)
    args = (x, ls, lb, w, b)
    got = ln_head(*args)
    ref = ln_head_ref(*args)
    torch.cuda.synchronize()
    differing = int((got != ref).sum())
    err_abs = float((got.float() - ref.float()).abs().max())
    ulps = bf16_ulps(got, ref)
    del ref
    comp_ms = _time_ms(lambda: xla_ln_head(*args), repeats)
    _record(results, "ln_head", "skoots_tpu_torch/csrc/lnhead.cu",
            "skoots_tpu/kernels/lnhead.py:53", float(differing), err_abs, 0.0,
            f"values differing ({ulps:.3g} bf16 ulp) at V={v} C={c}->{n} {dtn} [{route}]",
            _time_ms(lambda: ln_head(*args), repeats),
            _time_ms(lambda: ln_head_ref(*args), repeats),
            bound(nbytes(*args, got), **head_ops(v, c, n, dtn)),
            note=f" composition {comp_ms:.3f} ms")


def _check_upsample(results, r, shape, dt, repeats=REPEATS) -> None:
    """The 2x trilinear upsample of a ``shape`` ([B, X, Y, Z, C]) tensor
    of ``dt``: 0 differing bits. Least work: read the input, write the
    output and the separable cascade's 3 operations per blend (42 per
    input element). Library call: F.interpolate on the channels-last view
    (the same function, computed another way)."""
    import torch
    import torch.nn.functional as F

    from skoots_tpu_torch.kernels.upsample import upsample2x, upsample2x_ref

    x = _randn(r, shape, dtype=dt)
    got = upsample2x(x)
    ref = upsample2x_ref(x)
    torch.cuda.synchronize()
    bits = int((got != ref).sum())
    err_abs = float((got.float() - ref.float()).abs().max())
    del ref
    xv = x.permute(0, 4, 1, 2, 3)
    _record(results, "upsample2x", "skoots_tpu_torch/csrc/upsample.cu",
            "skoots_tpu/kernels/upsample.py:98", float(bits), err_abs, 0.0,
            f"values differing at {tuple(shape)} {str(dt)[6:]}",
            _time_ms(lambda: upsample2x(x), repeats),
            _time_ms(lambda: upsample2x_ref(x), repeats),
            bound(nbytes(x, got), fp32_flops=42.0 * x.numel()),
            _time_ms(lambda: F.interpolate(xv, scale_factor=2, mode="trilinear",
                                           align_corners=False), repeats))


def check_kernels() -> list:
    """Kernel vs plain version on the card at the main-path shapes."""
    import torch

    from skoots_tpu_torch.kernels.propagate import launch_plan, propagate, propagate_ref
    from skoots_tpu_torch.tools.bench_propagate import (
        SPARSE_PASSES,
        active_share,
        default_tile,
        sparse_bound_ms,
        sparse_case,
    )

    rng = np.random.default_rng(SEED)
    extra = np.random.default_rng(SEED + 3)  # the campaign slice's cases
    bf = torch.bfloat16
    results = []

    def record(*args, **kwargs):
        _record(results, *args, **kwargs)

    # 1.-3. the depthwise conv, the fused block tail and the fused final
    #    LN + 1x1 head at their cases (_check_dwconv, _check_tail,
    #    _check_ln_head say each one's bound, least work and library call)
    for i, case in enumerate(DWCONV_CASES + CAMPAIGN_DWCONV_CASES):
        _check_dwconv(results, rng if i < len(DWCONV_CASES) else extra, *case)
    # the stems' GEMMs at every width and k, from a generator on the card
    stems = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for case in STEM_DWCONV_CASES:
        _check_dwconv(results, stems, *case)
    # the run-time-k kernels' bf16 cases, from a generator on the card
    runtime_k = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for case in RUNTIME_K_CASES:
        _check_dwconv(results, runtime_k, *case)
    torch.cuda.empty_cache()
    for i, case in enumerate(TAIL_CASES + CAMPAIGN_TAIL_CASES):
        _check_tail(results, rng if i < len(TAIL_CASES) else extra, *case)
    for i, case in enumerate(LN_HEAD_CASES + CAMPAIGN_LN_HEAD_CASES):
        _check_ln_head(results, rng if i < len(LN_HEAD_CASES) else extra, *case)
    # the wide model's shapes (run_wide), from a generator on the card
    wide = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for case in WIDE_TAIL_CASES:
        _check_tail(results, wide, *case)
    for case in WIDE_LN_HEAD_CASES:
        _check_ln_head(results, wide, *case)
    torch.cuda.empty_cache()

    # 4. label propagation, Q = 4 passes, 26-conn, over the whole volume;
    #    exact. Foreground: 30% random voxels, which percolate, so labels
    #    keep moving in every pass
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fg = (torch.rand(VOLUME, device="cuda", generator=gen) < 0.3).to(torch.uint8)
    idx = torch.arange(1, fg.numel() + 1, dtype=torch.int32, device="cuda")
    lab = torch.where(fg > 0, idx.view(VOLUME), 0)

    def plain4():
        out = lab
        for _ in range(4):
            out = propagate_ref(out, fg)
        return out

    got = propagate(lab, fg, passes=4)
    ref = plain4()
    torch.cuda.synchronize()
    err_abs = float((got != ref).sum())
    # least time of the 4-pass function: labels and mask read once, labels
    # written once (the integer maxima are far below the bytes' time)
    record("propagate", "skoots_tpu_torch/csrc/propagate.cu",
           "skoots_tpu/kernels/propagate.py:93", err_abs, err_abs, 0.0,
           f"voxels differing at {VOLUME} Q=4",
           _time_ms(lambda: propagate(lab, fg, passes=4)), _time_ms(plain4),
           bound(nbytes(lab, fg, got)))
    del lab, fg, got, ref, idx

    # 4b. the main path's case: one CC round (192 passes, 26-conn) on the
    #     bench phantom's dilated skeleton (tools/bench_propagate.py); exact.
    #     Least time: the mask read and the labels written once, and 8 B per
    #     foreground voxel and pass
    lab, fg = sparse_case("cuda")

    def plain_round():
        out = lab
        for _ in range(SPARSE_PASSES):
            out = propagate_ref(out, fg)
        return out

    got = propagate(lab, fg, passes=SPARSE_PASSES)
    ref = plain_round()
    torch.cuda.synchronize()
    err_abs = float((got != ref).sum())
    record("propagate", "skoots_tpu_torch/csrc/propagate.cu",
           "skoots_tpu/kernels/propagate.py:93", err_abs, err_abs, 0.0,
           f"voxels differing at {VOLUME} {SPARSE_PASSES} passes, {int(fg.sum())} fg "
           f"voxels, {active_share(fg, default_tile()):.4f} of tiles active, "
           f"{len(launch_plan(SPARSE_PASSES))} launches",
           _time_ms(lambda: propagate(lab, fg, passes=SPARSE_PASSES)), _time_ms(plain_round),
           (sparse_bound_ms(fg, SPARSE_PASSES), "bytes"))
    del lab, fg, got, ref
    torch.cuda.empty_cache()

    # 5. 2x trilinear upsample at the decoder shapes of the bench tile, the
    #    host engine's tile and the training crop (batch 2), bf16 and f32
    #    (_check_upsample)
    for i, shape in enumerate(UPSAMPLE_SHAPES + CAMPAIGN_UPSAMPLE_SHAPES):
        for dt in (bf, torch.float32):
            _check_upsample(results, rng if i < len(UPSAMPLE_SHAPES) else extra, shape, dt)
    torch.cuda.empty_cache()
    return results


def check_microbenchmarks(results: list) -> None:
    """The two microbenchmarks through their tools, with the launch counts
    set to 0 before and read after: every row is checked against its plain
    version inside the tool. The kernel rows of the JSON line sum the
    card-filling runs (f32 FMA chain; the four load + FMA variants)."""
    import torch

    from skoots_tpu_torch.kernels.microbench import (
        N_ITER,
        SHAPE,
        fma_chain,
        fma_chain_ref,
        loadfma,
        loadfma_ref,
    )
    from skoots_tpu_torch.tools import bench_fma_rate, bench_loadfma

    fma_chain.launches = loadfma.launches = 0
    fma_rows = bench_fma_rate.measure(repeats=REPEATS)
    lf_rows = bench_loadfma.measure(repeats=REPEATS)
    torch.cuda.synchronize()
    launches = {"fma_chain": fma_chain.launches, "loadfma": loadfma.launches}
    print(f"microbenchmark launches {json.dumps(launches)}", flush=True)

    def once_ms(fn) -> float:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    # the plain versions on the same work, timed once (the f32 chain is
    # 8192 steps of an exact FMA built from f64 operations)
    fill = [r for r in fma_rows if r["dtype"] == "float32" and r["chains"] > 1]
    n = fill[0]["shape"][0]
    a = torch.full((n,), 1.000001, device="cuda")
    b = torch.full((n,), 0.9999, device="cuda")
    fma_plain = [once_ms(lambda: fma_chain_ref(a, b, N_ITER))]
    big = [r for r in lf_rows if r["reps"] > 1]
    rng = np.random.default_rng(SEED)
    buf = torch.from_numpy(rng.integers(-8, 9, SHAPE).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.integers(-8, 9, (1, 128)).astype(np.float32)).cuda()
    lf_plain = []
    for r in big:
        dyn, ch = r["variant"].startswith("dynamic"), 8 if "chains" in r["variant"] else 1
        lf_plain.append(once_ms(lambda: loadfma_ref(buf.expand(r["reps"], *SHAPE), w,
                                                    dyn, ch)))
    # the load + FMA variants' bounds from what their SASS issues a column
    from skoots_tpu_torch.kernels import _build

    sass = bench_loadfma.sass_counts(_build.library_path())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = bench_loadfma.sm_clock_hz()
    lf_bounds = []
    for r in big:
        least, by, f_ms, s_ms = bench_loadfma.variant_bound(sass[r["variant"]], r["reps"],
                                                            sms, clock)
        lf_bounds.append((least, by))
        print(f"loadfma {r['variant']}: {r['ms']:.4f} ms, SASS a column "
              f"{json.dumps(sass[r['variant']])}, bound {least:.4f} ms ({by}: FFMA "
              f"{f_ms:.4f}, shared memory {s_ms:.4f}; {sms} SMs at {clock / 1e6:.0f} MHz), "
              f"{100 * least / r['ms']:.1f}% of it", flush=True)
    for name, replaces, rows, plain, bounds in (
            ("fma_chain", "tools/bench_vpu_pallas.py:33", fill, fma_plain,
             [bound(0, fp32_flops=r["flops"]) for r in fill]),
            ("loadfma", "tools/bench_loadfma.py:88", big, lf_plain, lf_bounds)):
        _need(launches[name] > 0 and rows, f"{name} did not run")
        print(f"kernel {name}: {sum(r['ms'] for r in rows):.4f} ms on the card-filling "
              f"runs, plain {sum(plain):.3f} ms", flush=True)
        results.append({
            "name": name, "route": "cuda", "source": "skoots_tpu_torch/csrc/microbench.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": 0.0,
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(plain),
            "bound_ms": sum(b[0] for b in bounds),
            "bound_by": max(bounds)[1] if max(bounds)[1] != "shared memory" else "bytes",
            "library_ms": None, "_largest": 0.0})


def _iou_match(ref, other):
    """(instances of ``ref``, of ``other``, min over ``ref``'s instances of
    the IoU with its best-overlapping instance of ``other``)."""
    ids = [i for i in np.unique(ref) if i]
    ious = []
    for i in ids:
        m = ref == i
        cand, cnt = np.unique(other[m], return_counts=True)
        j = cand[np.argmax(np.where(cand > 0, cnt, -1))]
        ious.append(float((m & (other == j)).sum()) / float((m | (other == j)).sum())
                    if j else 0.0)
    return len(ids), len(np.unique(other)) - (1 if (other == 0).any() else 0), \
        min(ious, default=0.0)


def _no_plain_propagation(*args, **kwargs):
    raise RuntimeError("the plain propagation ran on the card")


def _launch_counters():
    """The wrappers of the forward kernels and propagate, by name."""
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.kernels.dwconv import dwconv3d
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x

    return {"dwconv3d": dwconv3d, "mlp_block_tail": mlp_block_tail,
            "ln_head": ln_head, "upsample2x": upsample2x,
            "propagate": prop_mod.propagate}


def _drive(tag: str, fn, results: list | None = None, kernels: dict | None = None):
    """Run ``fn()`` with the launch count of every kernel of ``kernels`` (by
    default :func:`_launch_counters`') set to 0 just before and read just
    after, the plain propagation barred; print the seconds and counts, and
    add the counts to ``results`` when it is given. Returns ``(fn's
    result, counts, seconds)``."""
    import torch

    from skoots_tpu_torch.kernels import propagate as prop_mod

    kernels = kernels or _launch_counters()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    saved, prop_mod.propagate_ref = prop_mod.propagate_ref, _no_plain_propagation
    try:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        prop_mod.propagate_ref = saved
    counts = {name: k.launches for name, k in kernels.items()}
    for r in results or ():
        r["launches"] += counts.get(r["name"], 0)
    print(f"{tag}: {dt:.3f} s, launches {json.dumps(counts)}", flush=True)
    return out, counts, dt


@contextlib.contextmanager
def _entry_routes(cstride: int, wgrad_operands: set | None = None):
    """While open, record the (dtype, C, k) of every launch whose x channel
    stride is ``cstride`` (0: a stem, one input channel read for all C; 1: a
    depthwise layer) at the library's entry points ``skoots_dwconv3d`` and
    ``skoots_dwconv3d_wgrad``; on closing, fill the yielded dict with the
    route of each, by kind ("forward", "wgrad"): the route queries, on the
    same integers. With ``wgrad_operands``, also add to it ``_check_wgrad``'s
    arguments (shape, input channels, C, k, dtype) of every weight-gradient
    launch, whatever its stride."""
    from skoots_tpu_torch.kernels import _build

    lib = _build.library()
    entries = {"forward": "skoots_dwconv3d", "wgrad": "skoots_dwconv3d_wgrad"}
    seen = {kind: set() for kind in entries}
    saved = {kind: getattr(lib, entry) for kind, entry in entries.items()}
    routes: dict = {}

    def recorder(kind):
        def launch(*args):  # dtype, x, ..., B, X, Y, Z (5-8), C, k, x_vstride, x_cstride, ...
            if args[12] == cstride:
                seen[kind].add((args[0], args[9], args[10]))
            if kind == "wgrad" and wgrad_operands is not None:
                wgrad_operands.add((tuple(args[5:9]), args[11], args[9], args[10],
                                    "bf16" if args[0] == 1 else "f32"))
            return saved[kind](*args)
        return launch

    for kind, entry in entries.items():
        setattr(lib, entry, recorder(kind))
    try:
        yield routes
    finally:
        for kind, entry in entries.items():
            setattr(lib, entry, saved[kind])
    routes.update({kind: {key: _build.route(entries[kind] + "_route", key[0], cstride, key[1],
                                            key[2]) for key in launched}
                   for kind, launched in seen.items()})


@contextlib.contextmanager
def _stem_routes(tag: str, expect: dict | None = None, wgrad_operands: set | None = None):
    """While open, record every stem launch (:func:`_entry_routes`, which
    also fills ``wgrad_operands``), and on closing print the route of each.
    With ``expect`` ({"forward": name, "wgrad": name}), every launch of each
    kind must take that kernel and each kind must have launched; without
    it, every bf16 stem the GEMMs take must have taken one."""
    import torch

    with _entry_routes(0, wgrad_operands) as routes:
        yield routes
    names = {0: "f32", 1: "bf16"}
    print(f"{tag}: stem launches' routes " + json.dumps(
        {kind: {f"{names[d]} 1->{c} k={k}": r for (d, c, k), r in v.items()}
         for kind, v in routes.items()}), flush=True)
    for kind, v in routes.items():
        if expect is not None and kind in expect:
            _need(set(v.values()) == {expect[kind]},
                  f"{tag}: stem {kind} launches routed to {sorted(v.values())}, expected "
                  f"{expect[kind]}")
        for (d, c, k), r in v.items():
            dt = torch.bfloat16 if d == 1 else torch.float32
            _need(not _gemm_stem(dt, 1, c, k) or r.startswith(
                ("stem_gemm_kernel<", "stem_gemm_chunk_kernel<", "stem_wgrad_tc_kernel<",
                 "stem_wgrad_chunk_kernel<")),
                f"{tag}: a bf16 stem 1 -> {c} k={k} {kind} launch took {r}")


def run_host_engine(results: list):
    """The host-streaming engine through ``run_inference`` at its defaults
    on a seeded 256^3 tube phantom (uint8 ``.npy``) with the bench
    checkpoint, then its ``--use-cached`` and out-of-core reruns, then a
    128x128x32 block on the card and on the CPU. Returns the phantom, the
    default run's instance count, the tubes placed, the default run's mask
    and the origin of the card-vs-CPU block."""
    import shutil

    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    work = os.path.join(ROOT, "build", "host_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    shape = HOST_VOLUME
    n_target = max(6, int(48 * (shape[0] * shape[1] * shape[2]) / 512**3))
    p0, p1, n_expected = tube_segments(shape, n_target, radius=5.0, seed=7)
    vol = render_tubes(shape, p0, p1, radius=5.0, device="cuda").round()
    vol = vol.to(torch.uint8).cpu().numpy()
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol)
    print(f"host engine: phantom {shape} uint8, {n_expected} tubes placed", flush=True)

    per_forward = FORWARD_KERNELS_PER_TILE

    def run(tag, into=None, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mask, counts, e2e = _drive(f"host engine [{tag}]", lambda: engine.run_inference(
            path, ckpt, output_path=os.path.join(work, f"mask_{tag}.npy"), **kw), into)
        stats = json.loads(json.dumps(engine.last_stats))
        mask = np.asarray(mask)
        n = len(np.unique(mask)) - 1
        print(f"host engine [{tag}]: {n} instances of {n_expected} placed, e2e "
              f"{e2e:.3f} s (run_inference), peak_device_memory_bytes "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
        print(f"host engine [{tag}] stages: {json.dumps(stats)}", flush=True)
        _need(stats["engine"] == "host", f"[{tag}] ran the {stats['engine']} engine")
        _need(counts["propagate"] == stats["phase2"]["cc_rounds"] > 0,
              f"[{tag}] propagate launches {counts['propagate']} against "
              f"{stats['phase2']['cc_rounds']} CC rounds")
        return mask, counts, stats

    # 1. defaults: auto -> host (256^3), store, the dilation probe on 4 tiles
    mask, counts, stats = run("defaults", results)
    forwards = 4 + stats["phase1"]["tiles"]
    for name, k in per_forward.items():
        _need(counts[name] == k * forwards,
              f"{name}: {counts[name]} launches, expected {k} x {forwards} forwards")
    n = n_default = len(np.unique(mask)) - 1
    default_mask = mask
    _need(0.8 * n_expected <= n <= n_expected + 4,
          f"n_instances {n} outside [0.8*{n_expected}, {n_expected}+4]")
    knobs = json.load(open(os.path.join(work, "phantom_skoots_phase1.json")))

    # 2. the phase-1 cache: no forward, the same mask
    cached, counts, _ = run("use_cached", use_cached_data=True)
    _need(all(counts[k] == 0 for k in per_forward), "the cached rerun ran the model")
    _need(np.array_equal(cached, mask), "the --use-cached rerun's mask differs")
    print("host engine [use_cached]: mask equal to the first run's", flush=True)

    # 3. out of core: recompute wire mode, memmapped buffers
    ooc, counts, stats = run("out_of_core", out_of_core=True)
    _need(stats["wire_mode"] == "recompute", "out of core did not recompute")
    forwards = 4 + stats["phase1"]["tiles"] + stats["phase3"]["tiles"]
    _need(counts["dwconv3d"] == 11 * forwards, f"out of core: {counts['dwconv3d']} "
          f"dwconv launches, expected 11 x {forwards}")
    n = len(np.unique(ooc)) - 1
    print(f"host engine [out_of_core]: {n} instances, {int((ooc != mask).sum())} voxels "
          f"differ from the first run", flush=True)
    _need(0.8 * n_expected <= n <= n_expected + 4, f"out of core: n_instances {n}")

    # 4. a 128x128x32 block (the one most tubes cross: connected pieces of
    #    over 500 bright voxels) on the card and on the CPU, as one tile with
    #    the first run's dilation stack
    from scipy import ndimage

    best, origin = (-1, -1), None
    for ox in range(0, shape[0] - 127, 32):
        for oy in range(0, shape[1] - 127, 32):
            for oz in range(0, shape[2] - 31, 16):
                bright = vol[ox:ox + 128, oy:oy + 128, oz:oz + 32] > 100
                lab, n = ndimage.label(bright, np.ones((3, 3, 3)))
                pieces = int((np.bincount(lab.ravel())[1:] > 500).sum()) if n else 0
                if (pieces, int(bright.sum())) > best:
                    best, origin = (pieces, int(bright.sum())), (ox, oy, oz)
    ox, oy, oz = origin
    block_path = os.path.join(work, "block.npy")
    np.save(block_path, np.ascontiguousarray(vol[ox:ox + 128, oy:oy + 128, oz:oz + 32]))
    masks = []
    for dev in ("cuda", "cpu"):
        masks.append(np.asarray(engine.run_inference(
            block_path, ckpt, crop_size=(128, 128, 32), overlap=(0, 0, 0),
            dilation_3d=knobs["dilation_3d"], dilation_2d=knobs["dilation_2d"],
            output_path=os.path.join(work, f"block_{dev}.npy"), device=dev)))
    n_cpu, n_card, min_iou = _iou_match(masks[1], masks[0])
    print(f"host engine card vs cpu on the block at {origin}: {n_card} vs {n_cpu} "
          f"instances, min IoU {min_iou:.4f}", flush=True)
    _need(n_cpu >= 1 and n_card == n_cpu and min_iou >= 0.95,
          "the host engine's instances on the card differ from the CPU's")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return vol, n_default, n_expected, default_mask, origin


# the single-program pipeline's card-vs-CPU block: the host engine's
# 128x128x32 block, cut into two forward tiles of JAX's default Z crop
DEVICE_PIPELINE_CPU_CROP = (128, 128, 16)
DEVICE_PIPELINE_REPEATS = 3


def _twin_state_layout(cfg) -> dict:
    """Key -> shape of the reference UNeXT twin's ``state_dict`` for ``cfg``
    (the layout of ``tests/test_compat.py::_build_torch_twin``, in its
    registration order: the stem, each encoder stage's blocks and its
    downsample, the bottleneck, each decoder stage's fuse and blocks, the
    final norm, the head and the three output heads)."""
    m = cfg["MODEL"]
    dims, depths, k = list(m["DIMS"]), list(m["DEPTHS"]), m["KERNEL_SIZE"]
    kd = len(dims) // 2
    out: dict = {"stem.weight": (dims[0], m["IN_CHANNELS"], k, k, k), "stem.bias": (dims[0],)}

    def block(prefix, d):
        out.update({prefix + "gamma": (d,), prefix + "dwconv.weight": (d, 1, k, k, k),
                    prefix + "dwconv.bias": (d,), prefix + "norm.weight": (d,),
                    prefix + "norm.bias": (d,), prefix + "pwconv1.weight": (4 * d, d),
                    prefix + "pwconv1.bias": (4 * d,), prefix + "pwconv2.weight": (d, 4 * d),
                    prefix + "pwconv2.bias": (d,)})

    for s in range(kd):
        for i in range(depths[s]):
            block(f"enc.{s}.{i}.", dims[s])
        p = f"enc.{s}.{depths[s]}."
        out.update({p + "norm.weight": (dims[s],), p + "norm.bias": (dims[s],),
                    p + "conv.weight": (dims[s + 1], dims[s], 2, 2, 2),
                    p + "conv.bias": (dims[s + 1],)})
    for i in range(depths[kd]):
        block(f"bottleneck.{i}.", dims[kd])
    for s in range(kd):
        d = kd + 1 + s
        out.update({f"dec.{s}.fuse.weight": (dims[d], dims[d - 1] + dims[kd - 1 - s], 1, 1, 1),
                    f"dec.{s}.fuse.bias": (dims[d],)})
        for i in range(depths[d]):
            block(f"dec.{s}.blocks.{i}.", dims[d])
    c = m["OUT_CHANNELS"]
    out.update({"final_norm.weight": (dims[-1],), "final_norm.bias": (dims[-1],),
                "head_conv.weight": (c, dims[-1], 1, 1, 1), "head_conv.bias": (c,)})
    for head, n in (("vector", 3), ("skeleton", 1), ("semantic", 1)):
        out.update({f"{head}.weight": (n, c, 1, 1, 1), f"{head}.bias": (n,)})
    return out


def run_device_pipeline(results: list, vol, n_expected: int, block_origin) -> None:
    """The single-program pipeline (``infer/device_pipeline.py::
    make_device_pipeline``) at JAX's defaults (crop 256x256x16, overlap
    16x16x2, CC 32 rounds x 128 propagates and 1 jump, N = 10, bf16
    vectors) with the bench checkpoint's vector scale, on the 256^3 host
    phantom: one run through :func:`_drive` with every kernel's operands
    recorded (each forward kernel ``FORWARD_KERNELS_PER_TILE`` x tiles,
    propagate ``len(launch_plan(128))`` a CC round), the instances inside
    the phantom's bar, the warm e2e (median of ``DEVICE_PIPELINE_REPEATS``),
    phase split and reserved peak; the same pipeline on the host engine's
    block, card against CPU; every kernel against its plain version at the
    operand shapes the run gave it (levels of Z = 16, 8 and 4); then
    ``segment_volume_chunked`` against the ``make_chunked_pipeline`` it
    wraps; and a ``.trch`` round trip: the checkpoint's weights exported
    to the reference twin's ``state_dict`` layout (``export_torch_state``),
    saved with a dict cfg, converted back (``convert_trch``): parameters
    bit for bit and the pipeline's mask equal."""
    import torch

    from skoots_tpu_torch import checkpoint
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.config import to_plain
    from skoots_tpu_torch.infer import (make_chunked_pipeline, make_device_pipeline,
                                        segment_volume_chunked)
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.models import model_from_checkpoint
    from skoots_tpu_torch.ops import flood_fill
    from skoots_tpu_torch.utils.torch_compat import convert_trch, export_torch_state

    dev = torch.device("cuda")
    ckpt_path = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    ckpt = load_checkpoint(ckpt_path)
    model = model_from_checkpoint(ckpt, device=dev)
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    scale = tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"])
    shape = tuple(vol.shape)
    volume = torch.from_numpy(vol).to(dev)
    run = make_device_pipeline(model, shape, vector_scale=scale, device=dev)

    seen: dict = {}
    with _kernel_operands(seen, cc=flood_fill):
        inst, counts, _ = _drive("device pipeline", lambda: run(volume, mean, std), results)
    _need(tuple(inst.shape) == shape and inst.dtype == torch.int32,
          f"device pipeline output {tuple(inst.shape)} {inst.dtype}")
    want = {k: v * run.tile_plan["forward"] for k, v in FORWARD_KERNELS_PER_TILE.items()}
    want["propagate"] = run.last_cc_rounds * len(prop_mod.launch_plan(128))
    _need(counts == want and counts["propagate"] > 0,
          f"device pipeline: launches {counts}, expected {want}")
    n_inst = int((torch.unique(inst) > 0).sum())
    _need(0.8 * n_expected <= n_inst <= n_expected + 4,
          f"device pipeline: {n_inst} instances outside [0.8*{n_expected}, {n_expected}+4]")

    walls, phases = [], []
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(DEVICE_PIPELINE_REPEATS):
        torch.cuda.synchronize()
        t0 = time.time()
        again = run(volume, mean, std)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        phases.append(dict(run.last_phase_s))
        _need(torch.equal(again, inst), "device pipeline: a warm rerun's mask differs")
    reserved = torch.cuda.max_memory_reserved() - base
    print(f"device pipeline: {n_inst} instances of {n_expected} placed; tiles "
          f"{run.tile_plan}; CC {run.last_cc_rounds} rounds (converged "
          f"{run.last_cc_converged}); warm e2e median {float(np.median(walls)):.3f} s of "
          f"{[round(w, 3) for w in walls]}; phases {json.dumps(phases)}; reserved peak "
          f"{reserved} B ({reserved / np.prod(shape):.1f} B a voxel)", flush=True)

    # the card against the plain versions on the CPU, on the host engine's block
    ox, oy, oz = block_origin
    block = volume[ox:ox + 128, oy:oy + 128, oz:oz + 32].contiguous()
    masks = []
    for d, m in ((dev, model), (torch.device("cpu"), model_from_checkpoint(ckpt, device="cpu"))):
        masks.append(make_device_pipeline(
            m, tuple(block.shape), crop=DEVICE_PIPELINE_CPU_CROP, vector_scale=scale,
            device=d)(block.to(d), mean, std).numpy())
    n_cpu, n_card, min_iou = _iou_match(masks[1], masks[0])
    print(f"device pipeline card vs cpu on the block at {block_origin}: {n_card} vs {n_cpu} "
          f"instances, min IoU {min_iou:.4f}", flush=True)
    _need(n_cpu >= 1 and n_card == n_cpu and min_iou >= 0.95,
          "the device pipeline's instances on the card differ from the CPU's")

    _check_sharded_kernels(results, seen, "the device pipeline's CC")

    # segment_volume_chunked is the chunked pipeline it builds
    chunked = make_chunked_pipeline(model, shape, vector_scale=scale, device=dev)(
        volume, mean, std)
    wrapped = segment_volume_chunked(model, volume, mean, std, vector_scale=scale,
                                     device=dev)
    n_chunked = int((torch.unique(chunked) > 0).sum())
    print(f"segment_volume_chunked: {n_chunked} instances, mask "
          f"{'equal to' if torch.equal(wrapped, chunked) else 'DIFFERENT from'} "
          "make_chunked_pipeline's", flush=True)
    _need(torch.equal(wrapped, chunked), "segment_volume_chunked differs from its pipeline")
    del chunked, wrapped

    # the .trch round trip: the twin's layout, a dict cfg, convert_trch
    work = os.path.join(ROOT, "build", "trch_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = to_plain(ckpt["cfg"])
    template = {k: np.zeros(v, np.float32) for k, v in _twin_state_layout(cfg).items()}
    state, exported, skipped, unused = export_torch_state(ckpt["params"], template,
                                                          ckpt["cfg"])
    _need(exported == len(template) and not skipped and not unused,
          f".trch export: {exported} of {len(template)}, skipped {skipped}, unused {unused}")
    src = os.path.join(work, "bench.trch")
    torch.save({"cfg": cfg, "model_state_dict": {k: torch.from_numpy(v) for k, v in
                                                 state.items()},
                "dataset_mean": mean, "dataset_std": std}, src)
    t0 = time.time()
    back = load_checkpoint(convert_trch(src))
    dt = time.time() - t0
    a, b = checkpoint._flat(ckpt["params"]), checkpoint._flat(back["params"])
    same = a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    trch_mask = make_device_pipeline(model_from_checkpoint(back, device=dev), shape,
                                     vector_scale=scale, device=dev)(volume, mean, std)
    print(f".trch round trip: {len(template)} tensors exported to the twin's layout, "
          f"converted in {dt:.2f} s ({back['extra']['mapped']} mapped, unmapped "
          f"{back['extra']['unmapped_torch_keys']}, unfilled "
          f"{back['extra']['unfilled_params']}); parameters "
          f"{'bit for bit equal' if same else 'DIFFERENT'}; device pipeline mask "
          f"{'equal' if torch.equal(trch_mask, inst) else 'DIFFERENT'}", flush=True)
    _need(same and back["extra"]["mapped"] == len(template),
          ".trch round trip: the converted parameters differ from the checkpoint's")
    _need(torch.equal(trch_mask, inst), ".trch round trip: the device pipeline's mask differs")
    shutil.rmtree(work, ignore_errors=True)
    del model, volume, inst, again, trch_mask
    torch.cuda.empty_cache()


def run_slice(results: list):
    """The main path on the bench checkpoint and phantom; returns
    ``(checkpoint, model, phantom, instance mask on the host, the run's
    peak reserved device bytes, the pipeline)`` for
    :func:`check_against_cpu` and :func:`run_thrifty`."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.models import model_from_checkpoint
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    dev = torch.device("cuda")
    t0 = time.time()
    ckpt = load_checkpoint(os.path.join(ROOT, "runs", "bench_ckpt.skoots"))
    model = model_from_checkpoint(ckpt, device=dev)
    cfg = ckpt["cfg"]
    mean = float(ckpt["dataset_mean"])
    std = float(ckpt["dataset_std"])
    shape = VOLUME
    n_target = max(6, int(48 * (shape[0] * shape[1] * shape[2]) / 512**3))
    p0, p1, n_expected = tube_segments(shape, n_target, radius=5.0, seed=7)
    volume = render_tubes(shape, p0, p1, radius=5.0, device=dev)
    torch.cuda.synchronize()
    print(f"setup: checkpoint + phantom {time.time() - t0:.2f} s "
          f"(volume {shape}, {n_expected} tubes placed)", flush=True)

    run = make_chunked_pipeline(
        model, shape, crop=TILE, overlap=(0, 0, 0), assign_crop=(256, 256, 64),
        vector_scale=tuple(cfg["SKOOTS"]["VECTOR_SCALING"]),
        embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
        cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0,
        device=dev,
    )
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    with _stem_routes("inference", {"forward": BENCH_STEM_ROUTES["forward"]}):
        inst, counts, e2e = _drive("inference", lambda: run(volume, mean, std), results)
    # the run's own peaks, over the phantom and the model it was given:
    # allocated, and reserved (what the card must have free)
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved

    _need(tuple(inst.shape) == shape and inst.dtype == torch.int32,
          f"output {tuple(inst.shape)} {inst.dtype}")
    n_instances = int((torch.unique(inst) > 0).sum())
    print(f"phases: {json.dumps(run.last_phase_s)} e2e {e2e:.3f} s", flush=True)
    print(f"n_instances {n_instances} n_expected {n_expected}", flush=True)
    print(f"cc_rounds {run.last_cc_rounds} cc_converged {run.last_cc_converged}",
          flush=True)
    print(f"peak_device_memory_bytes {peak}, reserved {reserved} (over the {base} B "
          "allocated before the run: the f32 phantom and the model)", flush=True)
    for name, n in counts.items():
        _need(n > 0, f"kernel {name} was not launched on the main path")
    n_tiles = int(np.prod([-(-v // t) for v, t in zip(shape, TILE)]))
    _need(counts["upsample2x"] == 2 * n_tiles,
          f"upsample2x: {counts['upsample2x']} launches, expected 2 x {n_tiles} tiles")
    per_round = len(prop_mod.launch_plan(192))
    _need(counts["propagate"] == run.last_cc_rounds * per_round,
          f"propagate: {counts['propagate']} launches, expected {run.last_cc_rounds} CC "
          f"rounds x {per_round}")
    _need(0.8 * n_expected <= n_instances <= n_expected + 4,
          f"n_instances {n_instances} outside [0.8*{n_expected}, {n_expected}+4]")
    return ckpt, model, volume, inst, reserved, run


def check_against_cpu(ckpt, model, volume, min_instances: int = 1) -> None:
    """The same pipeline on a 128x128x64 block of the phantom that three
    tubes cross, on the card and with every kernel's plain version on the
    CPU (which the CPU tests hold against the JAX package): finite model
    output, the same instance count (at least ``min_instances``), every
    instance at IoU >= 0.95."""
    import torch

    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.models import model_from_checkpoint

    block = volume[192:320, 192:320, 192:256].contiguous()
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    out = model(((block - mean) / std)[None, ..., None])
    _need(bool(torch.isfinite(out).all()) and tuple(out.shape) == (1, *block.shape, 5),
          f"model output {tuple(out.shape)} not finite or of the wrong shape")
    masks = []
    for dev, m in ((torch.device("cuda"), model),
                   (torch.device("cpu"), model_from_checkpoint(ckpt, device="cpu"))):
        run = make_chunked_pipeline(
            m, tuple(block.shape), crop=TILE, overlap=(0, 0, 0),
            assign_crop=(256, 256, 64),
            vector_scale=tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]),
            embed_iterations=10, embed_compact_div=16, cc_rounds=24,
            cc_propagates_per_round=192, cc_jumps_per_round=0, device=dev)
        masks.append(run(block.to(dev), mean, std).numpy())
    card, cpu = masks
    ids = [i for i in np.unique(cpu) if i]
    ious = []
    for i in ids:
        m = cpu == i
        cand, cnt = np.unique(card[m], return_counts=True)
        j = cand[np.argmax(np.where(cand > 0, cnt, -1))]
        ious.append(float((m & (card == j)).sum()) / float((m | (card == j)).sum())
                    if j else 0.0)
    n_card = len(np.unique(card)) - 1
    print(f"card vs cpu on {tuple(block.shape)}: {n_card} vs {len(ids)} instances, "
          f"min IoU {min(ious, default=0.0):.4f}", flush=True)
    _need(len(ids) >= min_instances and n_card == len(ids) and min(ious, default=1.0) >= 0.95,
          "the card's instances differ from the plain versions' on the CPU")


@contextlib.contextmanager
def _plain_model_kernels(names):
    """While open, the model's forward kernels named in ``names``
    (``models/unext.py``'s ``dwconv3d``, ``mlp_block_tail``, ``ln_head``,
    ``upsample2x``) are their plain versions, on whatever device the tensors
    lie."""
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_ref
    from skoots_tpu_torch.kernels.lnhead import ln_head_ref
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail_ref
    from skoots_tpu_torch.kernels.upsample import upsample2x_ref
    from skoots_tpu_torch.models import unext

    plain = {"dwconv3d": dwconv3d_ref, "mlp_block_tail": mlp_block_tail_ref,
             "ln_head": ln_head_ref, "upsample2x": upsample2x_ref}
    saved = {name: getattr(unext, name) for name in names}
    for name in names:
        setattr(unext, name, plain[name])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(unext, name, fn)


def run_wide(results: list, volume, bench_model, default_run) -> None:
    """The 1.5x-wide UNeXT3D (``WIDE_MODEL``: the bench checkpoint's cfg
    with ``MODEL.DIMS`` 48-96-192-96-48, random weights from ``SEED``,
    written as a ``.skoots`` under ``build/``) through
    ``make_chunked_pipeline`` on the 512^3 bench phantom at ``bench.py``'s
    knobs, as :func:`run_slice` drives the bench model: launch counts exact
    (each forward kernel a tile, propagate a CC round), every block-tail and
    LN-head launch routed to a width-class or staged kernel (the route
    query at each operand shape the run gave them), each kernel against its
    plain version at those shapes; the ``1-forward`` phase cold and warm
    beside the bench model's; one tile's prob > 0.8 decisions with the
    card's kernels against the plain versions on the card, also with only
    the tail and head or only the dwconv and upsample swapped, and the
    bench model's (the share equal printed; every voxel farther than
    ``DECISION_MARGIN`` from 0.8 alike); one f32 train step's loss and
    gradients card vs CPU at these widths."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from skoots_tpu_torch.config import cfg_from_dict
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.kernels.lnhead import ln_head_route
    from skoots_tpu_torch.kernels.mlp import mlp_tail_route
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.ops import flood_fill

    t0 = time.time()
    dev = torch.device("cuda")
    bench = load_checkpoint(os.path.join(ROOT, "runs", "bench_ckpt.skoots"))
    cfg = cfg_from_dict(bench["cfg"])
    cfg["MODEL"].update(WIDE_MODEL)
    mean, std = float(bench["dataset_mean"]), float(bench["dataset_std"])
    path = os.path.join(ROOT, "build", "wide_smoke", "wide.skoots")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_checkpoint(path, cfg, init_model(cfg, SEED, device="cpu").state_dict(),
                    dataset_mean=mean, dataset_std=std)
    model = model_from_checkpoint(load_checkpoint(path), device=dev)
    run = make_chunked_pipeline(
        model, VOLUME, crop=TILE, overlap=(0, 0, 0), assign_crop=ASSIGN_TILE,
        vector_scale=tuple(cfg["SKOOTS"]["VECTOR_SCALING"]),
        embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
        cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0, device=dev)
    print(f"wide model {WIDE_MODEL['DIMS']}: random init, {path}, "
          f"{time.time() - t0:.1f} s", flush=True)

    seen: dict = {}
    with _kernel_operands(seen, cc=flood_fill), _stem_routes(
            "wide model: inference", {"forward": WIDE_STEM_ROUTES["forward"]}):
        inst, counts, _ = _drive("wide model: inference", lambda: run(volume, mean, std),
                                 results)
    cold = dict(run.last_phase_s)
    want = {k: v * run.tile_plan["forward"] for k, v in FORWARD_KERNELS_PER_TILE.items()}
    want["propagate"] = run.last_cc_rounds * len(prop_mod.launch_plan(192))
    _need(counts == want, f"wide model: launches {counts}, expected {want}")
    _need(tuple(inst.shape) == VOLUME and inst.dtype == torch.int32,
          f"wide model: output {tuple(inst.shape)} {inst.dtype}")
    routes = {c: mlp_tail_route(torch.bfloat16, c) for _, c, _ in seen["mlp_block_tail"]}
    routes.update({(c, n): ln_head_route(torch.bfloat16, c, n)
                   for _, c, n, _ in seen["ln_head"]})
    print(f"wide model: routes {json.dumps({str(k): v for k, v in routes.items()})}",
          flush=True)
    _need(all(r is not None and r.startswith(("tail_class_kernel<", "tail_staged_kernel<",
                                                "ln_head_class_kernel<"))
              for r in routes.values()) and len(routes) == 4,
          f"wide model: a launch left the width-class kernels ({routes})")
    _, again, _ = _drive("wide model: warm rerun", lambda: run(volume, mean, std))
    _need(again == want, f"wide model: rerun launches {again}, expected {want}")
    n_instances = int((torch.unique(inst) > 0).sum())
    print(f"wide model: 1-forward {cold['1-forward']:.3f} s cold, "
          f"{run.last_phase_s['1-forward']:.3f} s warm (bench model "
          f"{default_run.last_phase_s['1-forward']:.3f} s); phases "
          f"{json.dumps(run.last_phase_s)}; {n_instances} instances, CC rounds "
          f"{run.last_cc_rounds}", flush=True)
    del inst
    r = torch.Generator(device="cuda").manual_seed(SEED + 9)
    for case in sorted(seen["mlp_block_tail"]):
        _check_tail(results, r, *case, repeats=SHARDED_REPEATS)
    for case in sorted(seen["ln_head"]):
        _check_ln_head(results, r, *case, repeats=SHARDED_REPEATS)
    torch.cuda.empty_cache()
    # the stem, the depthwise convs and the upsamples at the run's shapes,
    # from a generator of their own
    r = torch.Generator(device="cuda").manual_seed(SEED + 12)
    for case in sorted(seen["dwconv3d"]):
        _check_dwconv(results, r, *case, repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
    for shape, dt in sorted(seen["upsample2x"], key=lambda case: case[0]):
        _check_upsample(results, r, shape, dt, repeats=SHARDED_REPEATS)
    torch.cuda.empty_cache()

    # one tile's prob > 0.8 decisions: the card's kernels against their
    # plain versions, all four or only some swapped, and the bench model's
    tile = ((volume[:TILE[0], :TILE[1], :TILE[2]] - mean) / std)[None, ..., None]
    agree = {}
    for tag, m, plain in (
            ("wide", model, ("dwconv3d", "mlp_block_tail", "ln_head", "upsample2x")),
            ("wide, tail and head plain", model, ("mlp_block_tail", "ln_head")),
            ("wide, dwconv and upsample plain", model, ("dwconv3d", "upsample2x")),
            ("bench", bench_model, ("dwconv3d", "mlp_block_tail", "ln_head", "upsample2x"))):
        with torch.no_grad():
            fast = m(tile)[0, ..., 4].float()
            with _plain_model_kernels(plain):
                slow = m(tile)[0, ..., 4].float()
        flips = (fast > 0.8) != (slow > 0.8)
        agree[tag] = float(1.0 - flips.float().mean())
        far = (slow - 0.8).abs() > DECISION_MARGIN
        near = float(((slow - 0.8).abs() <= 2 ** -8).float().mean())
        print(f"decisions [{tag}]: {agree[tag]:.6f} equal, max |dp| "
              f"{float((fast - slow).abs().max()):.4g}; {near:.4f} "
              f"of the voxels within a bf16 ulp of 0.8; flips farther than "
              f"{DECISION_MARGIN:g} from it: {int((flips & far).sum())}", flush=True)
        _need(not bool((flips & far).any()),
              f"decisions [{tag}]: a voxel over {DECISION_MARGIN:g} from 0.8 decides otherwise")
    print(f"wide model: decisions {agree['wide']:.6f} equal "
          f"({'at or above' if agree['wide'] >= 0.999 else 'below'} 0.999)", flush=True)
    del model, run, tile, fast, slow
    torch.cuda.empty_cache()
    check_grads_against_cpu(WIDE_MODEL, tag="wide 48-96-192")
    run_wide_train_step(results)
    print(f"wide model: {time.time() - t0:.1f} s in all", flush=True)


def run_wide_train_step(results: list, model_update: dict = WIDE_MODEL,
                        tag: str = "wide model", stem_routes: dict | None = WIDE_STEM_ROUTES,
                        operands: dict | None = None) -> float:
    """One bf16 training step of the wide model (``model_update`` changes
    ``MODEL`` of the bench cfg: ``WIDE_MODEL`` by default; random weights
    from ``SEED``) at the bench checkpoint's training cfg (crop 96x96x32,
    batch 1) on a seeded tube crop: the median of 5 CUDA-event runs of the
    step (forward and loss, backward, optimizer update) after a warm one,
    each kernel's launches counted over the 5 (exact: 21 dwconv (11
    forward, 10 input gradients), 11 weight gradients, 10 block tails, 1 LN
    head, 2 upsamples a step), the stem's forward and weight gradient on
    their GEMMs (``stem_routes``, or any GEMM when None: the route of every
    launch). With ``operands`` (a dict), the forward kernels' operands
    (:func:`_kernel_operands`) and the weight gradient's
    (``operands["dwconv3d_wgrad"]``) of the 5 steps are recorded into it.
    Returns the median step in ms."""
    import torch

    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.utils.synthetic import make_tubes

    dev = torch.device("cuda")
    cfg = _bench_train_cfg()
    cfg["MODEL"].update(model_update)
    _need(cfg["MODEL"]["DTYPE"] == "bfloat16" and cfg["TRAIN"]["TRAIN_BATCH_SIZE"] == 1,
          f"{tag} train step: cfg {cfg['MODEL']['DTYPE']}, batch "
          f"{cfg['TRAIN']['TRAIN_BATCH_SIZE']}")
    img, labels, skels = make_tubes(shape=TRAIN_CROP, n_tubes=4, radius=5, seed=5)
    packed = pack_skeletons(skels)
    batch = {
        "image": torch.from_numpy((img.astype(np.float32) - 41.8) / 20.4)[None, ..., None],
        "masks": torch.from_numpy((labels > 0).astype(np.float32))[None, ..., None],
        "baked": bake_skeleton(torch.from_numpy(labels), packed,
                               tuple(cfg["AUGMENTATION"]["BAKE_SKELETON_ANISOTROPY"]))[None],
        "skele_masks": skeleton_to_mask(packed, TRAIN_CROP, 3, 3)[None, ..., None],
    }
    batch = {k: v.to(dev) for k, v in batch.items()}
    model = init_model(cfg, SEED, device=dev).train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)

    def one():
        opt.zero_grad(set_to_none=True)
        total, _ = step.loss_fn(batch, 0)
        total.backward()
        step.apply_update(0)
        return float(total.detach())

    one()
    torch.cuda.synchronize()

    def five():
        times, losses = [], []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses.append(one())
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return times, losses

    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head, "upsample2x": upsample2x}
    with contextlib.ExitStack() as stack:
        stack.enter_context(_stem_routes(
            f"{tag}: bf16 train step", stem_routes,
            None if operands is None else operands.setdefault("dwconv3d_wgrad", set())))
        if operands is not None:
            stack.enter_context(_kernel_operands(operands))
        (times, losses), counts, _ = _drive(f"{tag}: bf16 train step x5", five, results,
                                            kernels)
    per_step = {"dwconv3d": 21, "dwconv3d_wgrad": 11, "mlp_block_tail": 10, "ln_head": 1,
                "upsample2x": 2}
    print(f"{tag}: bf16 train step (crop {TRAIN_CROP}, batch 1) median of 5 "
          f"{float(np.median(times)):.3f} ms (runs {[round(t, 3) for t in times]}); losses "
          f"{[round(v, 6) for v in losses]}", flush=True)
    _need(all(np.isfinite(losses)), f"{tag} train step: losses {losses}")
    for name, c in counts.items():
        _need(c == 5 * per_step[name],
              f"{tag} train step: {name} {c} launches, expected {5 * per_step[name]}")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return float(np.median(times))


@contextlib.contextmanager
def _depthwise_routes(tag: str, k: int):
    """While open, record every depthwise launch (:func:`_entry_routes`); on
    closing, every launch of each kind must have taken the big-k kernel of
    ``k``, so no run-time-k kernel ran."""
    with _entry_routes(1) as routes:
        yield routes
    expect = {"forward": f"dwconv3d_big_kernel<{k}>", "wgrad": f"dwconv3d_wgrad_big_kernel<{k}>"}
    print(f"{tag}: depthwise launches' routes " + json.dumps(
        {kind: {f"{'bf16' if d == 1 else 'f32'} C={c} k={kk}": r for (d, c, kk), r in v.items()}
         for kind, v in routes.items()}), flush=True)
    for kind, v in routes.items():
        _need(all(r == expect[kind] for r in v.values()),
              f"{tag}: depthwise {kind} launches routed to {sorted(set(v.values()))}, "
              f"expected {expect[kind]}")


def run_kernel_sizes(results: list, volume, default_run) -> None:
    """The bench checkpoint's cfg with ``MODEL.KERNEL_SIZE`` set to each of
    ``KERNEL_SIZES`` (dims 32-64-128-64-32, depth 2, bf16; random weights
    from ``SEED``, written as a ``.skoots`` under ``build/``), as
    :func:`run_wide` drives the wide model: through ``make_chunked_pipeline``
    on the 512^3 bench phantom at ``bench.py``'s knobs, cold then warm,
    launch counts exact, every depthwise launch on the big-k kernel of its k
    (:func:`_depthwise_routes`) and every stem on a GEMM; each forward kernel
    against its plain version at the run's operand shapes, cuDNN beside;
    ``1-forward`` beside the bench model's; one tile's prob > 0.8 decisions
    with the kernels against the plain versions (no voxel farther than
    ``DECISION_MARGIN`` from 0.8 flips); one bf16 train step (median of 5,
    launches exact, every depthwise weight gradient on the big-k kernel;
    the forward and weight gradient held to their plain versions at the
    step's shapes). Then one f32 train step at k = 9 card vs CPU (the
    run-time-k f32 kernels)."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from skoots_tpu_torch.config import cfg_from_dict
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.ops import flood_fill

    t0 = time.time()
    dev = torch.device("cuda")
    bench = load_checkpoint(os.path.join(ROOT, "runs", "bench_ckpt.skoots"))
    mean, std = float(bench["dataset_mean"]), float(bench["dataset_std"])
    want = None
    for k in KERNEL_SIZES:
        tag = f"k = {k} model"
        cfg = cfg_from_dict(bench["cfg"])
        cfg["MODEL"]["KERNEL_SIZE"] = k
        path = os.path.join(ROOT, "build", "kernel_sizes", f"k{k}.skoots")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_checkpoint(path, cfg, init_model(cfg, SEED, device="cpu").state_dict(),
                        dataset_mean=mean, dataset_std=std)
        model = model_from_checkpoint(load_checkpoint(path), device=dev)
        run = make_chunked_pipeline(
            model, VOLUME, crop=TILE, overlap=(0, 0, 0), assign_crop=ASSIGN_TILE,
            vector_scale=tuple(cfg["SKOOTS"]["VECTOR_SCALING"]),
            embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
            cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0, device=dev)
        seen: dict = {}
        with _kernel_operands(seen, cc=flood_fill), _stem_routes(f"{tag}: inference"), \
                _depthwise_routes(f"{tag}: inference", k):
            inst, counts, _ = _drive(f"{tag}: inference", lambda: run(volume, mean, std),
                                     results)
        cold = dict(run.last_phase_s)
        want = {n: v * run.tile_plan["forward"] for n, v in FORWARD_KERNELS_PER_TILE.items()}
        want["propagate"] = run.last_cc_rounds * len(prop_mod.launch_plan(192))
        _need(counts == want, f"{tag}: launches {counts}, expected {want}")
        _need(tuple(inst.shape) == VOLUME and inst.dtype == torch.int32,
              f"{tag}: output {tuple(inst.shape)} {inst.dtype}")
        n_instances = int((torch.unique(inst) > 0).sum())
        del inst
        with _depthwise_routes(f"{tag}: warm rerun", k):
            _, again, _ = _drive(f"{tag}: warm rerun", lambda: run(volume, mean, std))
        _need(again == want, f"{tag}: rerun launches {again}, expected {want}")
        print(f"{tag}: 1-forward {cold['1-forward']:.3f} s cold, "
              f"{run.last_phase_s['1-forward']:.3f} s warm (bench model "
              f"{default_run.last_phase_s['1-forward']:.3f} s); phases "
              f"{json.dumps(run.last_phase_s)}; {n_instances} instances, CC rounds "
              f"{run.last_cc_rounds}", flush=True)
        r = torch.Generator(device="cuda").manual_seed(SEED + 20 + k)
        for case in sorted(seen["dwconv3d"]):
            _check_dwconv(results, r, *case, repeats=SHARDED_REPEATS)
            torch.cuda.empty_cache()
        for case in sorted(seen["mlp_block_tail"]):
            _check_tail(results, r, *case, repeats=SHARDED_REPEATS)
        for case in sorted(seen["ln_head"]):
            _check_ln_head(results, r, *case, repeats=SHARDED_REPEATS)
        for shape, dt in sorted(seen["upsample2x"], key=lambda case: case[0]):
            _check_upsample(results, r, shape, dt, repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
        # one tile's prob > 0.8 decisions, the kernels against the plain versions
        tile = ((volume[:TILE[0], :TILE[1], :TILE[2]] - mean) / std)[None, ..., None]
        with torch.no_grad():
            fast = model(tile)[0, ..., 4].float()
            with _plain_model_kernels(("dwconv3d", "mlp_block_tail", "ln_head", "upsample2x")):
                slow = model(tile)[0, ..., 4].float()
        flips = (fast > 0.8) != (slow > 0.8)
        far = (slow - 0.8).abs() > DECISION_MARGIN
        print(f"decisions [{tag}]: {float(1.0 - flips.float().mean()):.6f} equal, max |dp| "
              f"{float((fast - slow).abs().max()):.4g}; flips farther than "
              f"{DECISION_MARGIN:g} from 0.8: {int((flips & far).sum())}", flush=True)
        _need(not bool((flips & far).any()),
              f"decisions [{tag}]: a voxel over {DECISION_MARGIN:g} from 0.8 decides otherwise")
        del model, run, tile, fast, slow, flips, far
        torch.cuda.empty_cache()
        # one bf16 train step, then the depthwise kernels at its shapes
        step_seen: dict = {}
        with _depthwise_routes(f"{tag}: bf16 train step", k):
            run_wide_train_step(results, {"KERNEL_SIZE": k}, tag, None, step_seen)
        r = torch.Generator(device="cuda").manual_seed(SEED + 40 + k)
        for case in sorted(step_seen["dwconv3d"]):
            _check_dwconv(results, r, *case, repeats=SHARDED_REPEATS)
        for shape, cin, c, kk, dtn in sorted(step_seen["dwconv3d_wgrad"]):
            _check_wgrad(results, r, shape, cin, c, kk, dtn, f"{tag} train step",
                         repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
        print(f"{tag}: {time.time() - t0:.1f} s so far", flush=True)
    check_grads_against_cpu({"KERNEL_SIZE": 9}, tag="k = 9")
    print(f"kernel sizes: {time.time() - t0:.1f} s in all", flush=True)


def run_thrifty(results: list, ckpt, model, volume, chunked, chunked_peak,
                chunked_run) -> None:
    """The device-thrifty pipeline on the bench phantom as ``skoots
    --image`` gives it one, a uint8 host array (the phantom rounded), with
    the main path's knobs, launch counts set to 0 just before and read just
    after (every forward kernel per forward of its tile plan, propagate per
    CC round, the plain propagation barred); its peak device memory over
    what was allocated before, held against ``estimated_device_bytes``
    with one forward tile's peak measured as ``auto`` measures it; a
    second, warm run (the same mask), then the chunked pipeline again, for
    times taken in turns; then ``skoots-validate``'s metrics on the card
    with the thrifty mask as the prediction and the chunked pipeline's as
    the ground truth, F1@0.5 >= 0.95, and the card's IoU, Dice and clDice
    tables held against the same functions on the CPU. Returns the uint8
    phantom and the tile's peak bytes for :func:`run_thrifty_engine`."""
    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.device_pipeline import (
        estimated_device_bytes,
        make_thrifty_pipeline,
    )
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.ops.flood_fill import (
        _compact_labels,
        make_label_components_stepped,
        widen_u16,
    )
    from skoots_tpu_torch.utils.synthetic import tube_segments
    from skoots_tpu_torch.validate import metrics
    from skoots_tpu_torch.validate.cli import run_validation

    dev = torch.device("cuda")
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    n_expected = tube_segments(VOLUME, 48, radius=5.0, seed=7)[2]
    vol_u8 = volume.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    vox = int(np.prod(VOLUME))
    run = make_thrifty_pipeline(
        model, VOLUME, crop=TILE, overlap=(0, 0, 0), assign_crop=ASSIGN_TILE,
        vector_scale=tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]),
        embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
        cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0,
        device=dev,
    )
    torch.cuda.empty_cache()
    tile_bytes = engine._forward_tile_bytes(model, [TILE, ASSIGN_TILE], 0.8, 0.8, 1, 2,
                                            dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    inst, counts, e2e = _drive("thrifty", lambda: run(vol_u8, mean, std), results)
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved
    labels = widen_u16(inst)
    ids = torch.unique(labels)
    n_instances = int((ids > 0).sum())
    est = estimated_device_bytes(VOLUME, thrifty=True, itemsize=1, tile_bytes=tile_bytes)
    est_chunked = estimated_device_bytes(VOLUME, tile_bytes=tile_bytes)
    print(f"thrifty (uint8 host volume) phases: {json.dumps(run.last_phase_s)} e2e "
          f"{e2e:.3f} s", flush=True)
    print(f"thrifty n_instances {n_instances} n_expected {n_expected} components "
          f"{run.last_count} mask {inst.dtype} cc_rounds {run.last_cc_rounds} "
          f"cc_converged {run.last_cc_converged}", flush=True)
    print(f"thrifty tile plan {json.dumps(run.tile_plan)}", flush=True)
    print(f"thrifty peak_device_memory_bytes {peak}, reserved {reserved} (over {base} B "
          f"allocated before); one forward tile reserves {tile_bytes} B; beyond it "
          f"{(reserved - tile_bytes) / vox:.3f} B a voxel reserved (estimate 13), "
          f"estimate {est} B; chunked (f32 phantom on the card) reserved {chunked_peak}, "
          f"{(chunked_peak - tile_bytes) / vox:.3f} B a voxel beyond the tile (estimate "
          f"24), estimate {est_chunked} B", flush=True)
    _need(reserved <= est, f"thrifty reserved {reserved} B over its estimate {est} B")
    _need(chunked_peak <= est_chunked,
          f"chunked reserved {chunked_peak} B over its estimate {est_chunked} B")
    _need(tuple(inst.shape) == VOLUME, f"thrifty output {tuple(inst.shape)}")
    _need(inst.dtype == (torch.uint16 if run.last_count < 2**16 else torch.int32),
          f"thrifty mask {inst.dtype} for {run.last_count} components")
    _need(int(ids[0]) == 0 and int(ids[-1]) <= run.last_count,
          f"thrifty labels up to {int(ids[-1])}, not numbered 1..{run.last_count}")
    forwards = run.tile_plan["forward"] + run.tile_plan["assign"]
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == k * forwards,
              f"thrifty {name}: {counts[name]} launches, expected {k} x {forwards} "
              "forwards")
    per_round = len(prop_mod.launch_plan(192))
    _need(counts["propagate"] == run.last_cc_rounds * per_round > 0,
          f"thrifty propagate: {counts['propagate']} launches, expected "
          f"{run.last_cc_rounds} CC rounds x {per_round}")
    _need(0.8 * n_expected <= n_instances <= n_expected + 4,
          f"thrifty n_instances {n_instances} outside [0.8*{n_expected}, {n_expected}+4]")
    # phase 2 alone, where the per-voxel term peaks: the CC and the 16-bit
    # compaction on the mask of the thrifty instances (on the host), over
    # that mask on the card
    fg = (labels > 0).to(torch.uint8).to(dev)
    cc = make_label_components_stepped(VOLUME, rounds_per_dispatch=1,
                                       propagates_per_round=192, jumps_per_round=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    compact, n_cc = _compact_labels(cc(fg, max_rounds=24), narrow16=True)
    torch.cuda.synchronize()
    cc_peak = torch.cuda.max_memory_reserved() - base_reserved
    # the pipeline holds the uint8 volume and the mask beside it
    cc_per_voxel = cc_peak / vox + 2
    print(f"thrifty phase 2 alone (CC {cc.last_rounds} rounds + compaction to {n_cc} "
          f"labels, {compact.dtype}): {cc_peak} B reserved over the mask, "
          f"{cc_per_voxel:.3f} B a voxel with the volume and the mask (estimate 13)",
          flush=True)
    _need(cc_per_voxel <= 13, f"thrifty phase 2 takes {cc_per_voxel:.3f} B a voxel")
    del fg, compact
    for name, again, vol in (("thrifty", run, vol_u8), ("chunked", chunked_run, volume)):
        torch.cuda.synchronize()
        t0 = time.time()
        out = again(vol, mean, std)
        torch.cuda.synchronize()
        print(f"{name} again: phases {json.dumps(again.last_phase_s)} e2e "
              f"{time.time() - t0:.3f} s", flush=True)
        if again is run:
            _need(torch.equal(widen_u16(out), labels),
                  "the thrifty pipeline's second mask differs")
        del out
    torch.cuda.empty_cache()

    work = os.path.join(ROOT, "build", "validate_smoke")
    os.makedirs(work, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.time()
    res = run_validation(chunked, labels, os.path.join(work, "thrifty"),
                         plots=False, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"validate (thrifty vs chunked, card): F1@0.5 {res['f1@50']:.6f} mean IoU "
          f"{res['mean_iou']:.6f} mean clDice {res['mean_cldice']:.6f} over-seg "
          f"{res['over_segmentation_rate']:.4f} under-seg "
          f"{res['under_segmentation_rate']:.4f} in {dt:.3f} s", flush=True)
    _need(res["f1@50"] >= 0.95, f"thrifty vs chunked F1@0.5 {res['f1@50']} < 0.95")
    for fn in ("mask_iou", "mask_dice", "mask_soft_cldice"):
        card = getattr(metrics, fn)(chunked, labels, device=dev).cpu()
        cpu = getattr(metrics, fn)(chunked, labels, device="cpu")
        err = float((card - cpu).abs().max()) if card.numel() else 0.0
        tol = 1e-5 if fn == "mask_soft_cldice" else 0.0
        print(f"validate {fn}: card vs cpu {tuple(card.shape)} max |d| {err:.3g} "
              f"(bound {tol:g})", flush=True)
        _need(card.shape == cpu.shape and err <= tol,
              f"{fn}: the card's table differs from the CPU's by {err}")
    shutil.rmtree(work, ignore_errors=True)
    del inst, labels
    torch.cuda.empty_cache()
    return vol_u8, tile_bytes


def run_thrifty_engine(results: list, vol_u8, tile_bytes: int) -> None:
    """``run_inference`` on the uint8 phantom (an ``.npy``, as ``skoots
    --image`` reads one) with the bench checkpoint: first with
    ``engine_impl="device-thrifty"``, then with ``auto`` on a card whose
    free memory a ballast tensor cuts to halfway between the thrifty and
    the chunked estimates, where ``auto`` must take the thrifty pipeline
    and finish. Launch counts set to 0 just before each run and read just
    after: each forward kernel per forward (the 4 dilation-probe tiles,
    ``auto``'s one measured tile, the pipeline's tile plan), propagate per
    CC round; the phases JSON's engine, the instance count."""
    import torch

    from skoots_tpu_torch.infer import engine, sharded
    from skoots_tpu_torch.infer.device_pipeline import estimated_device_bytes
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.utils.synthetic import tube_segments

    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    work = os.path.join(ROOT, "build", "thrifty_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol_u8)
    n_expected = tube_segments(VOLUME, 48, radius=5.0, seed=7)[2]
    dev = torch.device("cuda")

    def run(tag, engine_impl, measured_tiles):
        mask, counts, e2e = _drive(f"run_inference [{tag}]", lambda: engine.run_inference(
            path, ckpt, engine_impl=engine_impl,
            output_path=os.path.join(work, f"mask_{tag}.npy")), results)
        with open(os.path.join(work, "phantom_skoots_phases.json")) as f:
            stats = json.load(f)
        n = len(np.unique(mask)) - 1
        print(f"run_inference [{tag}]: {n} instances of {n_expected} placed, e2e "
              f"{e2e:.3f} s; phases {json.dumps(stats)}", flush=True)
        _need(stats["engine"] == "device-thrifty",
              f"[{tag}] ran the {stats['engine']} engine, not device-thrifty")
        forwards = 4 + measured_tiles + sum(stats["tile_plan"].values())
        for name, k in FORWARD_KERNELS_PER_TILE.items():
            _need(counts[name] == k * forwards,
                  f"[{tag}] {name}: {counts[name]} launches, expected {k} x {forwards}")
        # run_inference's CC: the pipeline's default 128 passes a round
        per_round = len(prop_mod.launch_plan(128))
        _need(counts["propagate"] == stats["cc_rounds"] * per_round > 0,
              f"[{tag}] propagate: {counts['propagate']} launches, expected "
              f"{stats['cc_rounds']} CC rounds x {per_round}")
        _need(0.8 * n_expected <= n <= n_expected + 4,
              f"[{tag}] n_instances {n} outside [0.8*{n_expected}, {n_expected}+4]")
        return stats

    run("device-thrifty", "device-thrifty", 0)

    est = {"device": estimated_device_bytes(VOLUME, tile_bytes=tile_bytes),
           "device-thrifty": estimated_device_bytes(VOLUME, thrifty=True, itemsize=1,
                                                    tile_bytes=tile_bytes)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    target = (est["device"] + est["device-thrifty"]) // 2
    ballast = torch.empty(sharded.device_bytes_limit(dev) - target, dtype=torch.uint8,
                          device=dev)
    print(f"auto: a {ballast.numel()} B ballast leaves {sharded.device_bytes_limit(dev)} B "
          f"free (estimates {json.dumps(est)})", flush=True)
    try:
        stats = run("auto", "auto", 1)
    finally:
        del ballast
        torch.cuda.empty_cache()
    auto = stats["auto"]
    _need(auto["estimated_bytes"]["device-thrifty"] <= auto["free_bytes"]
          < auto["estimated_bytes"]["device"],
          f"auto: free {auto['free_bytes']} B not between the estimates "
          f"{json.dumps(auto['estimated_bytes'])}")
    shutil.rmtree(work, ignore_errors=True)


# the scale slice's volume: 67 M voxels, over the host engine's 256^3, so
# 'auto' sends it to a card; tubes placed by the scale tool's generator
SCALE_VOLUME = (512, 512, 256)
SCALE_TUBES = 24


def _same_partition(a, b) -> bool:
    """Whether two label volumes split the voxels the same way, up to the
    numbering (on the card)."""
    import torch

    a = torch.from_numpy(np.asarray(a)).cuda().long().view(-1)
    b = torch.from_numpy(np.asarray(b)).cuda().long().view(-1)
    pairs = torch.unique(a * (int(b.max()) + 1) + b).numel()
    return bool(((a == 0) == (b == 0)).all()) and \
        pairs == torch.unique(a).numel() == torch.unique(b).numel()


def run_scale(results: list) -> None:
    """The scale tool's proof at ``SCALE_VOLUME`` (its function, in this
    process; the full-size runs are the tool's own calls): ``auto`` must
    choose the chunked pipeline and stay at or under its estimate, and the
    host engine out of core must give the in-RAM run's partition. Launch
    counts from 0 around each run: each forward kernel per forward (the 4
    dilation-probe tiles, ``auto``'s measured tile, the tile plans),
    propagate per CC round (the pipeline's 128 passes a round; the host
    engine's one a round). Then every kernel against its plain version at
    the operand shapes of the ``auto`` run (the levels of its 192x192x96
    tiles and of the 256x256x64 tile ``auto`` measures, the whole-volume
    CC's labels and mask)."""
    import torch

    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.ops import flood_fill
    from skoots_tpu_torch.tools import bigvol_proof
    from skoots_tpu_torch.tools.accuracy_campaign import score

    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    work = os.path.join(ROOT, "build", "scale_smoke")
    shutil.rmtree(work, ignore_errors=True)
    saved = os.environ.get("SKOOTS_NO_TRACEMALLOC")
    os.environ["SKOOTS_NO_TRACEMALLOC"] = "1"
    t_phase = time.time()
    try:
        def band(tag, n, placed):
            print(f"scale [{tag}]: {n} instances of {placed} placed", flush=True)
            _need(0.8 * placed <= n <= placed + 4,
                  f"scale [{tag}]: n_instances {n} outside [0.8*{placed}, {placed}+4]")

        def check_forwards(tag, counts, forwards):
            for name, k in FORWARD_KERNELS_PER_TILE.items():
                _need(counts[name] == k * forwards,
                      f"scale [{tag}] {name}: {counts[name]} launches, expected "
                      f"{k} x {forwards}")

        def prove(tag, engine_impl):
            rec, counts, _ = _drive(f"scale [{tag}]", lambda: bigvol_proof.prove(
                SCALE_VOLUME, work, "tubes", SCALE_TUBES, ckpt, engine_impl, tag,
                "cuda"), results)
            print(f"scale [{tag}]: {json.dumps({k: rec[k] for k in ('engine_ran', 'wall_s', 'auto', 'estimated_bytes', 'device_memory_stats', 'cc_rounds', 'cc_converged', 'vs_gt', 'peak_anon_rss_mb')})}",
                  flush=True)
            band(tag, rec["n_instances"], rec["n_placed"])
            return rec, counts

        seen: dict = {}
        with _kernel_operands(seen, cc=flood_fill):
            auto, counts = prove("auto", "auto")
        _need(auto["engine_ran"] == "device", f"auto chose {auto['engine_ran']}")
        _need(auto["reserved_within_estimate"],
              f"auto: reserved {auto['reserved_peak_bytes']} B over the estimate "
              f"{auto['estimated_bytes']} B")
        _need(auto["cc_converged"], "auto: the CC stopped unconverged")
        check_forwards("auto", counts, 4 + 1 + auto["phases"]["tile_plan"]["forward"])
        per_round = len(prop_mod.launch_plan(128))
        _need(counts["propagate"] == auto["cc_rounds"] * per_round > 0,
              f"scale [auto] propagate: {counts['propagate']} launches, expected "
              f"{auto['cc_rounds']} rounds x {per_round}")

        host, counts = prove("host_ooc", None)
        phases = host["phases"]
        _need(host["engine_ran"] == "host" and host["out_of_core"],
              "the host run was not out of core")
        check_forwards("host_ooc", counts, 4 + phases["phase1"]["tiles"]
                       + phases["phase3"]["tiles"])
        _need(counts["propagate"] == host["cc_rounds"] > 0,
              f"scale [host_ooc] propagate: {counts['propagate']} launches, "
              f"expected {host['cc_rounds']} CC rounds")

        # the same run in RAM, with the knobs the first baked into its buffers
        knobs = json.load(open(os.path.join(work, "bigvol_tubes_skoots_phase1.json")))
        in_ram, counts, _ = _drive("scale [host_in_ram]", lambda: engine.run_inference(
            os.path.join(work, "bigvol_tubes.npy"), ckpt, crop_size=bigvol_proof.CROP,
            overlap=bigvol_proof.OVERLAP, assign_crop_size=bigvol_proof.ASSIGN_CROP,
            assign_overlap=bigvol_proof.ASSIGN_OVERLAP, engine_impl="host",
            out_of_core=False, wire_mode="recompute", dilation_3d=knobs["dilation_3d"],
            dilation_2d=knobs["dilation_2d"],
            output_path=os.path.join(work, "in_ram.npy")), results)
        stats = engine.last_stats
        _need(stats["engine"] == "host" and not stats["out_of_core"], "in RAM: wrong engine")
        check_forwards("host_in_ram", counts, stats["phase1"]["tiles"]
                       + stats["phase3"]["tiles"])
        ooc = np.load(os.path.join(work, "instance_host_ooc.npy"), mmap_mode="r")
        _need(_same_partition(in_ram, ooc),
              "the out-of-core host run's mask differs from the in-RAM run's")
        print("scale: out-of-core mask equal to the in-RAM one up to the numbering",
              flush=True)
        agree = score(ooc, np.load(os.path.join(work, "instance_auto.npy"), mmap_mode="r"),
                      "cuda")
        print(f"scale: auto against host {json.dumps(agree)}", flush=True)
        _need(agree["f1_at_iou50"] >= 0.95, f"scale: auto against host F1 {agree}")
        _check_sharded_kernels(results, seen, "the scale run's whole-volume CC input")
    finally:
        if saved is None:
            os.environ.pop("SKOOTS_NO_TRACEMALLOC", None)
        else:
            os.environ["SKOOTS_NO_TRACEMALLOC"] = saved
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"scale: phase {time.time() - t_phase:.1f} s", flush=True)


def check_sparse_probe(results: list, ckpt, model, volume) -> None:
    """``infer.engine._probe_semantic_threshold`` (the sparse checkpoint's
    gate) with the bench model on the phantom at ``run_inference``'s probe
    geometry for 512^3, launch counts set to 0 just before and read just
    after (each forward kernel per probe tile); held against the same
    function on the CPU with the plain versions and the checkpoint's dtype
    on a block three tubes cross: the same histogram bin, or None on
    both."""
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.autoknobs import calibrate_semantic_threshold_from_histogram
    from skoots_tpu_torch.models import model_from_checkpoint

    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    vol = volume.cpu().numpy()[..., None]
    thr, counts, _ = _drive("sparse probe (card)", lambda: engine._probe_semantic_threshold(
        model, mean, std, vol, PROBE_TILE, PROBE_OVERLAP, "cuda"), results)
    print(f"sparse probe (card): threshold {thr}", flush=True)
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == 4 * k,
              f"probe {name}: {counts[name]} launches, expected {k} x 4 tiles")

    def bin_width(probs):
        """The logit width of the calibration histogram's bins."""
        v = probs[probs > 0.5]
        t = np.log(np.clip(v, 1e-6, 1 - 1e-7)) - np.log(np.clip(1 - v, 1e-7, 1))
        return (t.max() - t.min()) / 128 if v.size else 0.0

    def logit(p):
        return float(np.log(p) - np.log1p(-p))

    block = np.ascontiguousarray(vol[PROBE_CPU_BLOCK])

    def probe(m, device):
        probs = engine._probe_probabilities(m, mean, std, block, PROBE_CPU_TILE,
                                            (0, 0, 0), device)
        return calibrate_semantic_threshold_from_histogram(probs), probs

    card_thr, card_probs = probe(model, "cuda")
    print(f"sparse probe (card, {block.shape[:3]} block): threshold {card_thr}, "
          f"{int((card_probs > 0.5).sum())} values above 0.5, "
          f"{int((card_probs == 1.0).sum())} equal to 1, bin width "
          f"{bin_width(card_probs):.4f}", flush=True)
    # the checkpoint's own dtype (bf16) must land in the card's bin; an f32
    # copy is printed beside it but not held: bf16 probabilities above 0.5
    # come in steps of 2^-8 and mostly saturate at 1, so its histogram's
    # range, and with it the valley, differs
    model_dtype = ckpt["cfg"]["MODEL"]["DTYPE"]
    cpu_ckpt = {**ckpt, "cfg": {**ckpt["cfg"]}}
    for dtype in ("float32", model_dtype):
        cpu_ckpt["cfg"]["MODEL"] = {**ckpt["cfg"]["MODEL"], "DTYPE": dtype}
        cpu_model = model_from_checkpoint(cpu_ckpt, device="cpu")
        t0 = time.time()
        cpu_thr, probs = probe(cpu_model, "cpu")
        same = (card_thr is None and cpu_thr is None) or (
            card_thr is not None and cpu_thr is not None
            and abs(logit(card_thr) - logit(cpu_thr)) <= bin_width(probs))
        print(f"sparse probe (cpu, {dtype} model): threshold {cpu_thr} in "
              f"{time.time() - t0:.1f} s, bin width {bin_width(probs):.4f}, "
              f"{int((probs == 1.0).sum())} equal to 1; same bin as the card: {same}",
              flush=True)
    _need(same, f"probe: the card's threshold {card_thr} and the CPU's {cpu_thr} "
          f"({model_dtype}) are not in one histogram bin")


def check_train_kernels(results: list) -> None:
    """The training path's kernels against their plain versions at its
    shapes (crop 96x96x32 and its two coarser levels), and the autograd
    wiring of the block tail and LN head."""
    import torch

    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad, dwconv3d_wgrad_ref
    from skoots_tpu_torch.kernels.lnhead import ln_head, xla_ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail, xla_tail

    # the training path's cases draw from rng in the order of the checks
    # below since they were first made (so their inputs stay), the added
    # ones from extra
    rng = np.random.default_rng(SEED + 1)
    extra = np.random.default_rng(SEED + 2)
    bf = torch.bfloat16
    cx, cy, cz = TRAIN_CROP

    # 1. depthwise weight gradient (tools/bench_train_kernels.py's cases):
    #    the stem (1 -> 32, channel stride 0) and the three block widths at
    #    their levels (bf16: the tensor-core kernels), a ragged batch of 2
    #    (X, Y, Z no multiple of a tile) for the depthwise and the stem
    #    kernels, and one f32 shape (the FP32 kernel); bound 1e-3 *
    #    max|plain| (f32 sums of the same exact products in another order),
    #    and the same result from run to run (fixed-order sums)
    for name, x, g in wgrad_inputs(rng, extra):
        cin, c = x.shape[-1], g.shape[-1]
        got = dwconv3d_wgrad(x, g, 7)
        ref = dwconv3d_wgrad_ref(x, g, 7)
        torch.cuda.synchronize()
        _need(torch.equal(got, dwconv3d_wgrad(x, g, 7)),
              f"dwconv3d_wgrad {name}: differs run to run")
        err_abs = float((got - ref).abs().max())
        # library call: cuDNN's weight gradient on the channels-last views
        # (grouped per channel; the stem's dense 1 -> 32)
        xv, gv = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        groups = 1 if cin == 1 else c
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            library = _time_ms(lambda: torch.nn.grad.conv3d_weight(
                xv, (c, 1, 7, 7, 7), gv, padding=3, groups=groups))
        _record(results, "dwconv3d_wgrad", "skoots_tpu_torch/csrc/dwconv_wgrad.cu",
                "skoots_tpu/kernels/dwconv.py:782", err_abs / float(ref.abs().max()),
                err_abs, 1e-3, f"of max|plain| at {name} {tuple(x.shape[:4])} {cin}->{c} "
                f"{'bf16' if x.dtype == bf else 'f32'}",
                _time_ms(lambda: dwconv3d_wgrad(x, g, 7)),
                _time_ms(lambda: dwconv3d_wgrad_ref(x, g, 7)),
                wgrad_bound(x, g, got), library)
        del x, g, got, ref, xv, gv

    # 1b. the same at the campaign's training levels (its stem 1 -> 16: the
    #     stem GEMM with 16 channels) and at k = 9 and 11, from a generator
    #     of their own; then the stems' GEMMs at every width and k
    #     (STEM_WGRAD_CASES), from one on the card
    campaign = np.random.default_rng(SEED + 4)
    for case in CAMPAIGN_WGRAD_CASES:
        _check_wgrad(results, campaign, *case, "campaign")
    stems = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for case in STEM_WGRAD_CASES:
        _check_wgrad(results, stems, *case, "stem")
    runtime_k = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for case in RUNTIME_K_CASES:
        _check_wgrad(results, runtime_k, *case, "run-time k")
    torch.cuda.empty_cache()

    # 2. skeleton bake over one crop, anisotropy (1, 1, 3), exact: 8 box
    #    instances with P = 256 and 4,096 points inside them; the sparse
    #    loss's bake (every point of a sample as one instance against an
    #    all-ones mask, closest_skeleton; P = the bench cfg's
    #    MAX_SKELETON_POINTS, a quarter of it padding); equidistant
    #    duplicates (the first minimal point decides); 40 ids in every tile
    #    (more than the kernel lists: the full scan with the id compare)
    for name, masks, pts, ids in bake_cases(rng, extra, (cx, cy, cz), SPARSE_BAKE_POINTS):
        masks = masks.cuda()
        pts_t, ids_t = torch.from_numpy(pts).cuda(), torch.from_numpy(ids).cuda()
        got = bake_skeleton_kernel(masks, pts_t, ids_t, ANISO)
        ref = bake_skeleton_ref(masks, pts_t, ids_t, ANISO)
        torch.cuda.synchronize()
        diff = int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
        err_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        _record(results, "bake_skeleton", "skoots_tpu_torch/csrc/bake.cu",
                "skoots_tpu/kernels/bake.py:112", float(diff), err_abs, 0.0,
                f"values differing at {name} V={masks.numel()}",
                _time_ms(lambda: bake_skeleton_kernel(masks, pts_t, ids_t, ANISO)),
                _time_ms(lambda: bake_skeleton_ref(masks, pts_t, ids_t, ANISO)),
                bake_bound(masks, pts_t, ids_t, *got))
        del got, ref, masks

    # 3. the depthwise conv's bf16 input gradient (the forward kernel on the
    #    cotangent with tap-flipped weights) against its plain composition,
    #    at the training levels; 1 bf16 ulp
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_ref

    for (sx, sy, sz), c in (((cx, cy, cz), 32), ((cx // 2, cy // 2, cz // 2), 64),
                            ((cx // 4, cy // 4, cz // 4), 128)):
        x = _randn(rng, (1, sx, sy, sz, c), dtype=bf).requires_grad_()
        w = _randn(rng, (7, 7, 7, c), 1 / np.sqrt(343)).to(bf).float()
        b = _randn(rng, (c,), 0.1).to(bf).float()
        g = _randn(rng, (1, sx, sy, sz, c), 1e-3, dtype=bf)
        (dx,) = torch.autograd.grad(dwconv3d(x, w, b), x, g)
        want = dwconv3d_ref(g, torch.flip(w, (0, 1, 2)), torch.zeros_like(b))
        torch.cuda.synchronize()
        ulps = bf16_ulps(dx, want)
        print(f"dwconv3d input gradient at {(sx, sy, sz)} C={c} bf16: "
              f"max err {ulps:.3g} bf16 ulp (bound 1)", flush=True)
        _need(dx.dtype == bf and ulps <= 1.0, f"dwconv3d input gradient at C={c}: {ulps} ulp")
        del x, g, dx, want

    # 4. autograd wiring: each wrapper's gradients are exactly the autograd
    #    of its plain composition at the same inputs (the backward
    #    recomputes from them), at the path's widths
    def same_grads(fn, comp, args):
        out = fn(*args)
        g = torch.randn(out.shape, device="cuda").to(out.dtype)
        got = torch.autograd.grad(out, args, g)
        want = torch.autograd.grad(comp(*args), args, g)
        return all(torch.equal(a, b) for a, b in zip(got, want))

    v = cx * cy * cz
    for vv, c in ((v, 32), (v // 8, 64), (v // 64, 128)):
        args = [_randn(rng, (vv, c), dtype=bf), _randn(rng, (vv, c), 0.1, dtype=bf),
                _randn(rng, (c,), 0.1) + 1.0, _randn(rng, (c,), 0.1),
                _randn(rng, (c, 4 * c), 1 / np.sqrt(c)), _randn(rng, (4 * c,), 0.1),
                _randn(rng, (4 * c, c), 1 / np.sqrt(4 * c)), _randn(rng, (c,), 0.1),
                torch.full((c,), 0.5, device="cuda")]
        args = [a.requires_grad_() for a in args]
        ok = same_grads(mlp_block_tail, xla_tail, args)
        print(f"backward mlp_block_tail V={vv} C={c}: "
              f"{'equal' if ok else 'DIFFERENT'}", flush=True)
        _need(ok, f"mlp_block_tail backward differs from its composition at C={c}")
    args = [_randn(rng, (v, 32), dtype=bf), _randn(rng, (32,), 0.1) + 1.0,
            _randn(rng, (32,), 0.1), _randn(rng, (32, 32), 1 / np.sqrt(32)),
            _randn(rng, (32,), 0.1)]
    args = [a.requires_grad_() for a in args]
    ok = same_grads(ln_head, xla_ln_head, args)
    print(f"backward ln_head V={v} C=32->32: {'equal' if ok else 'DIFFERENT'}", flush=True)
    _need(ok, "ln_head backward differs from its composition")
    torch.cuda.empty_cache()


def _bench_train_cfg() -> dict:
    """The training cfg embedded in the bench checkpoint, on the defaults."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.config import cfg_from_dict

    return cfg_from_dict(load_checkpoint(os.path.join(ROOT, "runs", "bench_ckpt.skoots"))["cfg"])


def check_grads_against_cpu(model_update=None, tag: str = "bism_unext") -> None:
    """One f32 train step of the bench model at full width (dims
    32-64-128, depth 2, 7^3; ``model_update`` changes ``MODEL``, e.g. to
    UNet3D) on one seeded 32x32x16 batch, on the card and on the CPU (every
    kernel's plain version) from the same initial weights: loss within 1e-4
    relative, every gradient present, finite and within 1e-3 * max|g_cpu|.
    TF32 is off for the comparison."""
    import torch

    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.ops.skeleton import bake_skeleton, pack_skeletons, skeleton_to_mask
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.utils.synthetic import make_tubes

    cfg = _bench_train_cfg()
    cfg["MODEL"].update(model_update or {})
    cfg["MODEL"]["DTYPE"] = "float32"
    shape = (32, 32, 16)
    img, labels, skels = make_tubes(shape=shape, n_tubes=3, radius=3, seed=3)
    packed = pack_skeletons(skels)
    batch = {
        "image": torch.from_numpy((img.astype(np.float32) - 41.8) / 20.4)[None, ..., None],
        "masks": torch.from_numpy((labels > 0).astype(np.float32))[None, ..., None],
        "baked": bake_skeleton(torch.from_numpy(labels), packed,
                               tuple(cfg["AUGMENTATION"]["BAKE_SKELETON_ANISOTROPY"]))[None],
        "skele_masks": skeleton_to_mask(packed, shape, 3, 3)[None, ..., None],
    }
    runs = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (torch.device("cuda"), torch.device("cpu")):
            model = init_model(cfg, SEED, device=dev).train()
            opt, sched = cfg_optimizer(cfg, model.parameters())
            step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
            total, _ = step.loss_fn({k: v.to(dev) for k, v in batch.items()}, 0)
            total.backward()
            runs.append((float(total.detach()), {n: (None if p.grad is None else p.grad.cpu())
                                        for n, p in model.named_parameters()}))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (l_card, g_card), (l_cpu, g_cpu) = runs
    worst, worst_name = 0.0, ""
    for name, gc in g_cpu.items():
        gd = g_card[name]
        _need(gd is not None and gc is not None, f"{name}: no gradient")
        _need(bool(torch.isfinite(gd).all()), f"{name}: gradient not finite on the card")
        rel = float((gd - gc).abs().max()) / max(float(gc.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    print(f"grads card vs cpu ({tag}, f32, {shape}): loss {l_card:.8g} vs {l_cpu:.8g} "
          f"(rel {abs(l_card - l_cpu) / abs(l_cpu):.3g}, bound 1e-4); "
          f"{len(g_cpu)} gradients, worst {worst:.3g} of max|g_cpu| at {worst_name} "
          f"(bound 1e-3)", flush=True)
    _need(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu), "card and CPU losses differ")
    _need(worst <= 1e-3, f"gradient {worst_name} differs between card and CPU")


def run_train_slice(results: list) -> list:
    """The training path at the bench checkpoint's training cfg (bf16, crop
    96x96x32, batch 1) on two seeded 256x256x32 tube volumes with 8 tubes
    each, held in memory as ``VolumeRecord`` objects. Returns the records."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.train.data import (
        SkootsDataset,
        VolumeRecord,
        batch_iterator,
        prefetch_iterator,
    )
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step, train
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.train.transforms import make_batch_augment
    from skoots_tpu_torch.utils.synthetic import make_tubes

    dev = torch.device("cuda")
    cfg = _bench_train_cfg()
    t = cfg["TRAIN"]
    t["NUM_EPOCHS"] = 2
    t["SAVE_INTERVAL"] = 2
    t["SAVE_PATH"] = os.path.join(ROOT, "build", "train_smoke")
    seed = t["SEED"]
    t0 = time.time()
    records = []
    for i in range(2):
        img, labels, skels = make_tubes(shape=(256, 256, 32), n_tubes=8, radius=5, seed=i)
        records.append(VolumeRecord(img.astype(np.float32), labels, skels, f"tubes{i}"))
    dataset = SkootsDataset(records, cfg, sample_per_image=8)
    mean, std = dataset.mean_std(with_invert=cfg["AUGMENTATION"]["INVERT_RATE"] > 0)
    radius = dataset.object_radius()
    augment = make_batch_augment(cfg, mean, std, dataset.intensity_ceiling(), device=dev)
    bsz = t["TRAIN_BATCH_SIZE"]
    host = batch_iterator(dataset, bsz, 8, seed)
    print(f"train setup: {time.time() - t0:.2f} s (2 volumes (256, 256, 32), "
          f"mean {mean:.4f} std {std:.4f}, object radius {radius})", flush=True)

    # 8 steps on one augmented batch, from a seeded fresh init
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed, device=dev).train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
    gen = torch.Generator().manual_seed(seed)
    host_batches = list(host(0))
    fixed = augment(host_batches[0], gen)
    losses, splits = [], []
    for i in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        augment(host_batches[i], gen)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total, metrics = step.loss_fn(fixed, 0)
        ev[2].record()
        total.backward()
        ev[3].record()
        step.apply_update(0)
        ev[4].record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    with torch.no_grad():
        final = float(step.loss_fn(fixed, 0)[0])
    peak = torch.cuda.max_memory_allocated()
    warm = np.median(np.asarray(splits[1:]), axis=0)
    print(f"train losses over 8 steps on one batch: {[round(v, 6) for v in losses]}, "
          f"after step 8: {final:.6f}", flush=True)
    print(f"train step split (warm median of 7, ms): augment {warm[0]:.3f} "
          f"forward+loss {warm[1]:.3f} backward {warm[2]:.3f} optimizer {warm[3]:.3f} "
          f"step {warm[1:].sum():.3f}", flush=True)
    print(f"train peak_device_memory_bytes {peak}", flush=True)
    _need(all(np.isfinite(losses)) and final < losses[0],
          f"the loss did not fall over 8 steps: {losses[0]} -> {final}")
    del model, opt, step, fixed

    # train() for 2 epochs of 8 steps through the whole augmentation
    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head,
               "upsample2x": upsample2x, "bake_skeleton": bake_skeleton_kernel}
    host_pf = prefetch_iterator(host)

    def data_iter(epoch: int):
        g = torch.Generator().manual_seed(seed + epoch)
        for host_batch in host_pf(epoch):
            yield augment(host_batch, g)

    with _stem_routes("train()", BENCH_STEM_ROUTES):
        state, counts, wall = _drive("train()", lambda: train(
            cfg, data_iter, dev, dataset_mean=mean, dataset_std=std, object_radius=radius),
            results, kernels)
    n = state.step
    # per step: 11 depthwise convs forward (stem + 10 blocks) and 10 input
    # gradients (not the stem's), 11 weight gradients, 10 block tails,
    # 1 LN head, 2 upsamples (the backward is the plain cascade's vjp), one
    # bake per sample
    per_step = {"dwconv3d": 21, "dwconv3d_wgrad": 11, "mlp_block_tail": 10,
                "ln_head": 1, "upsample2x": 2, "bake_skeleton": bsz}
    print(f"train(): {n} steps in {wall:.3f} s, last epoch means "
          f"{json.dumps(state.epoch_means)}", flush=True)
    print(f"train launches {json.dumps(counts)} expected per step "
          f"{json.dumps(per_step)}", flush=True)
    for name, c in counts.items():
        _need(c > 0, f"kernel {name} was not launched by train()")
        _need(c == n * per_step[name], f"{name}: {c} launches, expected {n * per_step[name]}")

    ckpt = load_checkpoint(state.save_name)
    loaded = model_from_checkpoint(ckpt, device=dev)
    x = augment(host_batches[1], gen)["image"]
    with torch.no_grad():
        same = torch.equal(state.model.eval()(x), loaded(x))
    print(f"checkpoint {os.path.basename(state.save_name)}: epoch "
          f"{ckpt['extra']['epoch']}, reloaded forward "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    _need(same, "the reloaded checkpoint's forward differs from the trained model's")
    return records


def block_pillow() -> None:
    """Pillow is blocked for the whole run (any ``import PIL`` raises): the
    port reads and writes TIFF with its own codec (``utils/tiff.py``)."""
    import importlib.util

    installed = importlib.util.find_spec("PIL") is not None
    sys.modules["PIL"] = None
    print(f"Pillow blocked for the whole run (installed on this machine: {installed})",
          flush=True)


def run_tif(results: list, vol, npy_mask) -> None:
    """The 256^3 host phantom written as a ``.tif`` by the port's writer
    (one Deflate page per Z) and read back (MB/s of both), then ``skoots-torch
    --image phantom.tif`` (``cli.main``) with the bench checkpoint, launch
    counts set to 0 just before and read just after: its ``.tif`` mask,
    read back, equals the ``.npy`` run's."""
    import torch

    from skoots_tpu_torch import cli
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.utils.io import imread, imsave

    work = os.path.join(ROOT, "build", "tif_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tif = os.path.join(work, "phantom.tif")
    mb = vol.nbytes / 1e6
    t0 = time.time()
    imsave(tif, vol)
    t_write = time.time() - t0
    t0 = time.time()
    back = imread(tif)
    t_read = time.time() - t0
    print(f"tif: {vol.shape} {vol.dtype} ({mb:.1f} MB, {os.path.getsize(tif)} B on disk) "
          f"written {mb / t_write:.1f} MB/s, read {mb / t_read:.1f} MB/s, "
          f"{'equal' if np.array_equal(back, vol) else 'DIFFERENT'}", flush=True)
    _need(back.dtype == vol.dtype and np.array_equal(back, vol), "the tif read back differs")

    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    rc, counts, wall = _drive("tif: skoots-torch --image phantom.tif", lambda: cli.main(
        ["--image", tif, "--pretrained-checkpoint", ckpt, "--log", "1"]), results)
    stats = json.loads(json.dumps(engine.last_stats))
    t0 = time.time()
    mask = imread(os.path.join(work, "phantom_instance_mask.tif"))
    t_mask = time.time() - t0
    n = len(np.unique(mask)) - 1
    same = mask.shape == npy_mask.shape and np.array_equal(mask, npy_mask)
    print(f"tif: skoots-torch --image phantom.tif: rc {rc}, {n} instances in {wall:.3f} s, "
          f"engine {stats['engine']}, mask read {mask.nbytes / 1e6 / t_mask:.1f} MB/s "
          f"({mask.dtype}), {'equal to' if same else 'DIFFERENT from'} the .npy run's",
          flush=True)
    _need(rc == 0 and same, "the tif run's mask differs from the .npy run's")
    forwards = 4 + stats["phase1"]["tiles"]
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == k * forwards,
              f"tif {name}: {counts[name]} launches, expected {k} x {forwards}")
    _need(counts["propagate"] == stats["phase2"]["cc_rounds"] > 0, "tif: propagate")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# the new cfg values of the training cell: (tag, MODEL update)
TRAIN_VARIANTS = (("droppath_silu", {"DROP_PATH_RATE": 0.1, "ACTIVATION": "silu"}),
                  ("gamma0", {"LAYER_SCALE_INIT_VALUE": 0.0}),
                  ("bism_unet", {"ARCHITECTURE": "bism_unet"}))


def _train_cell(records):
    """(cfg, augment, host batches of one epoch, mean, std) of the training
    cell on ``records``."""
    from skoots_tpu_torch.train.data import SkootsDataset, batch_iterator
    from skoots_tpu_torch.train.transforms import make_batch_augment

    cfg = _bench_train_cfg()
    dataset = SkootsDataset(records, cfg, sample_per_image=8)
    mean, std = dataset.mean_std(with_invert=cfg["AUGMENTATION"]["INVERT_RATE"] > 0)
    augment = make_batch_augment(cfg, mean, std, dataset.intensity_ceiling(), device="cuda")
    host = batch_iterator(dataset, cfg["TRAIN"]["TRAIN_BATCH_SIZE"], 8, cfg["TRAIN"]["SEED"])
    return cfg, augment, list(host(0)), mean, std


def run_train_variants(results: list, records) -> str:
    """8 steps each of UNeXT with DropPath 0.1 and silu, with layer scale 0,
    and of ``bism_unet`` (UNet3D, 32-64-128-64-32, depth 2, 3^3) at the
    training cell, on one augmented batch, one more augmentation a step
    (the bake) inside the counted window: the loss (evaluated without
    DropPath) falls, and the launches are what the model implies (no block
    tail on the plain-tail variants; no dwconv, wgrad or LN head in UNet3D).
    Then one f32 UNet3D step card vs CPU. Returns UNet3D's checkpoint."""
    import torch

    from skoots_tpu_torch.checkpoint import save_checkpoint
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.train.engine import cfg_optimizer, flax_opt_state, make_train_step
    from skoots_tpu_torch.train.sigma import init_sigma

    base, augment, host_batches, mean, std = _train_cell(records)
    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head,
               "upsample2x": upsample2x, "bake_skeleton": bake_skeleton_kernel}
    bsz = base["TRAIN"]["TRAIN_BATCH_SIZE"]
    work = os.path.join(ROOT, "build", "variant_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    unet_ckpt = None
    for tag, update in TRAIN_VARIANTS:
        cfg = _bench_train_cfg()
        cfg["MODEL"].update(update)
        seed = cfg["TRAIN"]["SEED"]
        model = init_model(cfg, seed, device="cuda").train()
        opt, sched = cfg_optimizer(cfg, model.parameters())
        step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
        gen = torch.Generator().manual_seed(seed)
        fixed = augment(host_batches[0], gen)
        with torch.no_grad():
            first = float(step.loss_fn(fixed, 0)[0])

        def eight_steps():
            times = []
            for i in range(8):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                augment(host_batches[i], gen)
                a.record()
                step(fixed, 0)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            return times

        times, counts, _ = _drive(f"train variant {tag}", eight_steps, results, kernels)
        with torch.no_grad():
            final = float(step.loss_fn(fixed, 0)[0])
        unet = update.get("ARCHITECTURE") == "bism_unet"
        per_step = {"dwconv3d": 0 if unet else 21, "dwconv3d_wgrad": 0 if unet else 11,
                    "mlp_block_tail": 0, "ln_head": 0 if unet else 1, "upsample2x": 2,
                    "bake_skeleton": bsz}
        print(f"train variant {tag}: loss {first:.6f} -> {final:.6f} over 8 steps, step "
              f"{float(np.median(times[1:])):.3f} ms (warm median of 7)", flush=True)
        _need(np.isfinite(final) and final < first, f"{tag}: the loss did not fall")
        for name, c in counts.items():
            _need(c == 8 * per_step[name],
                  f"{tag} {name}: {c} launches, expected {8 * per_step[name]}")
        if unet:
            unet_ckpt = os.path.join(work, "unet.skoots")
            save_checkpoint(unet_ckpt, cfg, model.state_dict(),
                            flax_opt_state(opt, model, cfg, 8), dataset_mean=mean,
                            dataset_std=std)
        del model, opt, step, fixed
        torch.cuda.empty_cache()
    check_grads_against_cpu({"ARCHITECTURE": "bism_unet"}, "bism_unet")
    return unet_ckpt


def run_resume(records) -> None:
    """Train the training cell's model 4 steps on one batch, save it with its
    optimizer state, take a 5th step; then ``train()`` from that checkpoint
    with ``LOAD_PRETRAINED_OPTIMIZER`` for the same 5th step. The restored
    moments and step count equal the saved ones bit for bit, and the
    resumed step's parameters equal the uninterrupted run's within
    1e-2 * lr."""
    import copy

    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.train.engine import (cfg_optimizer, flax_opt_state,
                                               load_flax_opt_state, make_train_step, train)
    from skoots_tpu_torch.train.sigma import init_sigma

    cfg, augment, host_batches, mean, std = _train_cell(records)
    t = cfg["TRAIN"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same sums in both runs
    work = os.path.join(ROOT, "build", "resume_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    model = init_model(cfg, t["SEED"], device="cuda").train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
    fixed = augment(host_batches[0], torch.Generator().manual_seed(t["SEED"]))
    for _ in range(4):
        step(fixed, 0)
    path = os.path.join(work, "four.skoots")
    save_checkpoint(path, cfg, model.state_dict(), flax_opt_state(opt, model, cfg, 4),
                    dataset_mean=mean, dataset_std=std)
    saved = {n: {k: v.clone() for k, v in opt.state[p].items()}
             for n, p in model.named_parameters()}
    step(fixed, 0)
    fifth = {n: p.detach().clone() for n, p in model.named_parameters()}

    ck = load_checkpoint(path)
    fresh = model_from_checkpoint(ck, device="cuda").train()
    fresh_opt, _ = cfg_optimizer(cfg, fresh.parameters())
    count = load_flax_opt_state(fresh_opt, fresh, cfg, ck["opt_state"])
    differ = [f"{n}.{k}" for n, p in fresh.named_parameters() for k, v in saved[n].items()
              if not torch.equal(fresh_opt.state[p][k].to(v.device), v)]
    print(f"resume: {len(saved)} parameters' moments and step restored from "
          f"{os.path.basename(path)} (count {count}), {len(differ)} differ bit for bit",
          flush=True)
    _need(count == 4 and not differ, f"restored optimizer state differs at {differ[:4]}")

    rcfg = copy.deepcopy(cfg)
    rcfg["TRAIN"].update(PRETRAINED_MODEL_PATH=[path], LOAD_PRETRAINED_OPTIMIZER=True,
                         NUM_EPOCHS=1, SAVE_PATH=os.path.join(work, "resumed"))
    state = train(rcfg, lambda e: iter([fixed]), "cuda", dataset_mean=mean, dataset_std=std)
    worst = max(float((p.detach() - fifth[n]).abs().max())
                for n, p in state.model.named_parameters())
    lr = sched(0)
    resumed = load_checkpoint(state.save_name)["opt_state"]
    print(f"resume: train() with LOAD_PRETRAINED_OPTIMIZER took the 5th step: max |p - "
          f"p_uninterrupted| {worst:.3g} (bound 1e-2 * lr = {1e-2 * lr:.3g}); its checkpoint "
          f"holds count {int(resumed['count'])}", flush=True)
    _need(worst <= 1e-2 * lr, "the resumed step differs from the uninterrupted one")
    _need(int(resumed["count"]) == 5, "the resumed checkpoint's count is not 5")
    torch.backends.cudnn.deterministic = deterministic
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def run_unet_inference(results: list, ckpt_path: str) -> None:
    """UNet3D (the 8-step ``bism_unet`` checkpoint) through
    ``make_chunked_pipeline`` on the 512^3 bench phantom with ``bench.py``'s
    knobs, launch counts set to 0 just before and read just after: 2
    upsamples a tile, no dwconv, block tail or LN head, propagate per CC
    round; the phase split; one forward tile's reserved memory
    (``_forward_tile_bytes``); then card against CPU on the 128x128x64
    block: the model's probabilities, and the pipeline's instances (the
    barely trained model's instances are not held to the phantom's)."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.infer.device_pipeline import make_chunked_pipeline
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.models import model_from_checkpoint
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    dev = torch.device("cuda")
    ckpt = load_checkpoint(ckpt_path)
    model = model_from_checkpoint(ckpt, device=dev)
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    p0, p1, _ = tube_segments(VOLUME, 48, radius=5.0, seed=7)
    volume = render_tubes(VOLUME, p0, p1, radius=5.0, device=dev)
    tile_bytes = engine._forward_tile_bytes(model, [TILE], 0.8, 0.8, 1, 2, dev)
    run = make_chunked_pipeline(
        model, VOLUME, crop=TILE, overlap=(0, 0, 0), assign_crop=(256, 256, 64),
        vector_scale=tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]),
        embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
        cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0, device=dev)
    inst, counts, e2e = _drive("unet3d chunked", lambda: run(volume, mean, std), results)
    n_tiles = int(np.prod([-(-v // t) for v, t in zip(VOLUME, TILE)]))
    n = int((torch.unique(inst) > 0).sum())
    print(f"unet3d chunked: phases {json.dumps(run.last_phase_s)} e2e {e2e:.3f} s, "
          f"{n} instances (8 training steps: not held to the phantom's), cc_rounds "
          f"{run.last_cc_rounds}, one forward tile reserves {tile_bytes} B", flush=True)
    _need(tuple(inst.shape) == VOLUME, f"unet3d output {tuple(inst.shape)}")
    _need(counts["upsample2x"] == 2 * n_tiles,
          f"unet3d upsample2x: {counts['upsample2x']} launches, expected 2 x {n_tiles}")
    _need(counts["dwconv3d"] == counts["mlp_block_tail"] == counts["ln_head"] == 0,
          "unet3d launched a UNeXT kernel")
    _need(counts["propagate"] == run.last_cc_rounds * len(prop_mod.launch_plan(192)),
          "unet3d: propagate launches")
    _need(tile_bytes > 0, "no forward tile memory measured")
    block = volume[192:320, 192:320, 192:256].contiguous()
    x = ((block - mean) / std)[None, ..., None]
    with torch.no_grad():
        card = model(x).cpu()
        cpu = model_from_checkpoint(ckpt, device="cpu")(x.cpu())
    diff = (card[..., 3:5] - cpu[..., 3:5]).abs()
    print(f"unet3d output card vs cpu on {tuple(block.shape)}: probabilities mean |d| "
          f"{float(diff.mean()):.3g} (bound 4e-3, one bf16 ulp at 0.5-1), max "
          f"{float(diff.max()):.3g}; skeleton > 0.8 on {int((cpu[..., 3] > 0.8).sum())} "
          f"voxels (CPU)", flush=True)
    _need(bool(torch.isfinite(card).all()) and float(diff.mean()) <= 4e-3,
          "unet3d: the card's probabilities differ from the CPU's")
    check_against_cpu(ckpt, model, volume, min_instances=0)
    del model, volume, inst, run
    torch.cuda.empty_cache()


def check_yaml_reader() -> None:
    """``config.load_cfg_from_file`` on the bench checkpoint's training cfg
    with PyYAML blocked (the port's own YAML reader): it merges, validates,
    and agrees with the cfg the checkpoint embeds on every key of the
    file."""
    import importlib.util

    from skoots_tpu_torch.config import load_cfg_from_file, load_yaml, to_plain

    path = os.path.join(ROOT, "runs", "bench_ckpt_train", "cfg.yaml")
    installed = importlib.util.find_spec("yaml") is not None
    blocked = sys.modules.get("yaml", False)
    sys.modules["yaml"] = None  # any import of PyYAML now raises
    try:
        cfg = load_cfg_from_file(path)
        with open(path) as f:
            keys = [(sec, k) for sec, d in load_yaml(f.read()).items() for k in d]
    finally:
        if blocked is False:
            del sys.modules["yaml"]
        else:
            sys.modules["yaml"] = blocked
    ckpt_cfg = _bench_train_cfg()
    differ = [f"{s}.{k}" for s, k in keys if to_plain(cfg[s][k]) != to_plain(ckpt_cfg[s][k])]
    print(f"yaml reader: {os.path.relpath(path, ROOT)} merged and validated with PyYAML "
          f"blocked (installed on this machine: {installed}): {len(keys)} keys, MODEL.DIMS "
          f"{cfg['MODEL']['DIMS']}, TRAIN.SIGMA_DECAY {cfg['TRAIN']['SIGMA_DECAY']}; keys "
          f"differing from the checkpoint's cfg: {differ}", flush=True)
    _need(not differ and len(keys) > 10, f"the YAML reader's cfg differs at {differ}")


def run_experimental(results: list, vol, n_default: int, n_expected: int) -> None:
    """``skoots-torch --experimental`` (``cli.main``) with the bench
    checkpoint on the 256^3 host phantom as ``.npy``: the knobs the tuned
    eval passed to ``run_inference``, launch counts set to 0 just before
    and read just after (every forward kernel per forward, propagate per CC
    round, its plain version may not run), the instance count beside the
    default run's."""
    import shutil

    import torch

    from skoots_tpu_torch import cli
    from skoots_tpu_torch.experimental import eval as experimental_eval
    from skoots_tpu_torch.infer import engine

    work = os.path.join(ROOT, "build", "experimental_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol)
    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    seen = {}
    real = experimental_eval.run_inference

    def recording(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    experimental_eval.run_inference = recording
    try:
        rc, counts, wall = _drive("--experimental", lambda: cli.main(
            ["--image", path, "--pretrained-checkpoint", ckpt, "--log", "1",
             "--experimental"]), results)
    finally:
        experimental_eval.run_inference = real
    stats = json.loads(json.dumps(engine.last_stats))
    mask = np.load(os.path.join(work, "phantom_instance_mask.npy"))
    n = len(np.unique(mask)) - 1
    knobs = {k: seen.get(k) for k in ("prob_threshold", "dilation_3d", "dilation_2d",
                                      "embed_iterations", "embed_decay")}
    print(f"--experimental: rc {rc}, {n} instances (default knobs: {n_default}; "
          f"{n_expected} tubes placed) in {wall:.3f} s, knobs in effect {json.dumps(knobs)}, "
          f"engine {stats['engine']}", flush=True)
    _need(rc == 0 and n >= 1, f"--experimental: rc {rc}, {n} instances")
    _need(knobs == {"prob_threshold": 0.5, "dilation_3d": 0, "dilation_2d": 3,
                    "embed_iterations": 10, "embed_decay": 0.95},
          f"--experimental ran with {knobs}")
    forwards = stats["phase1"]["tiles"] + (stats["phase3"]["tiles"]
                                           if stats["wire_mode"] == "recompute" else 0)
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == k * forwards,
              f"--experimental {name}: {counts[name]} launches, expected {k} x {forwards}")
    _need(counts["propagate"] == stats["phase2"]["cc_rounds"] > 0,
          f"--experimental propagate: {counts['propagate']} launches against "
          f"{stats['phase2']['cc_rounds']} CC rounds")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


def run_skeletonize(volumes) -> list:
    """``train.generate_skeletons.calculate_skeletons(method="lee")`` (the
    host C++ Lee thinning, built at first use) on the training phase's
    seeded tube ``volumes`` (image, labels): every instance gets a point
    and at least 95% of the points lie in their own instance. Returns
    (image, labels, skeletons) per volume."""
    from skoots_tpu_torch.train.generate_skeletons import calculate_skeletons

    vols = []
    for i, (img, labels) in enumerate(volumes):
        t0 = time.time()
        skels = calculate_skeletons(labels, method="lee")
        dt = time.time() - t0
        ids = [int(k) for k in np.unique(labels) if k]
        own = total = 0
        for k, pts in skels.items():
            ii = np.clip(np.round(pts).astype(int), 0, np.asarray(labels.shape) - 1)
            own += int((labels[ii[:, 0], ii[:, 1], ii[:, 2]] == k).sum())
            total += len(pts)
        print(f"skeletonize (lee) volume {i} {labels.shape}: {dt:.3f} s (host; the first "
              f"call builds the library), {len(skels)} of {len(ids)} instances, "
              f"{total} points, {own / max(total, 1):.4f} inside their own instance",
              flush=True)
        _need(sorted(skels) == ids and all(len(v) >= 1 for v in skels.values()),
              f"skeletonize: instances {ids}, skeletons {sorted(skels)}")
        _need(own >= 0.95 * total, f"skeletonize: {own} of {total} points in their instance")
        vols.append((img, labels, skels))
    return vols


def run_sparse_train(results: list, vols) -> str:
    """Sparse training at the bench checkpoint's training cfg (bf16, crop
    96x96x32, batch 1, ``IS_SPARSE``) on in-memory ``SparseRecord``s of
    ``vols`` (background: more than ``SPARSE_BG_DIST`` voxels from a tube;
    the Lee skeletons as the annotation): 8 steps on one augmented batch
    for the step split, then ``train_sparse`` for 2 epochs of
    ``SPARSE_STEPS`` with the launch counts set to 0 before and read after
    (exact: per step and per calibrator forward), every loss finite, the
    checkpoint reloaded. Returns the checkpoint's path."""
    import logging

    import torch
    from scipy import ndimage

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.experimental.data import SparseDataset, SparseRecord
    from skoots_tpu_torch.experimental.sparse_engine import (
        make_sparse_augment,
        make_sparse_train_step,
        train_sparse,
    )
    from skoots_tpu_torch.experimental.sparse_loss import sparse_loss, vector_direction_penalty
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model, model_from_checkpoint
    from skoots_tpu_torch.ops.vec2embed import vector_to_embedding
    from skoots_tpu_torch.train.data import batch_iterator
    from skoots_tpu_torch.train.engine import cfg_optimizer
    from skoots_tpu_torch.train.sigma import init_sigma

    dev = torch.device("cuda")
    cfg = _bench_train_cfg()
    t = cfg["TRAIN"]
    t["NUM_EPOCHS"], t["SAVE_INTERVAL"] = 2, 2
    t["SAVE_PATH"] = os.path.join(ROOT, "build", "sparse_smoke")
    cfg["EXPERIMENTAL"]["IS_SPARSE"] = True
    seed = t["SEED"]
    records = [SparseRecord(img.astype(np.float32),
                            (ndimage.distance_transform_edt(labels == 0) > SPARSE_BG_DIST)
                            .astype(np.float32), None, skels, f"tubes{i}")
               for i, (img, labels, skels) in enumerate(vols)]

    # 8 steps on one augmented batch, split with CUDA events
    dataset = SparseDataset(records, cfg, sample_per_image=t["TRAIN_SAMPLE_PER_IMAGE"][0])
    mean = float(np.mean([r.image.mean() for r in dataset.records]))
    std = float(np.mean([r.image.std() for r in dataset.records]))
    augment = make_sparse_augment(cfg, mean, std, dev)
    host_batches = list(batch_iterator(dataset, t["TRAIN_BATCH_SIZE"], 8, seed)(0))
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, seed, device=dev).train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_sparse_train_step(model, opt, sched, init_sigma(cfg), cfg)
    fixed = augment(host_batches[0], gen)
    losses, splits = [], []
    for i in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        augment(host_batches[i], gen)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        total, metrics = step.loss_fn(fixed, 0)
        ev[2].record()
        total.backward()
        ev[3].record()
        step.apply_update(0)
        ev[4].record()
        torch.cuda.synchronize()
        losses.append(float(metrics["loss"]))
        splits.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
    peak = torch.cuda.max_memory_allocated()
    warm = np.median(np.asarray(splits[1:]), axis=0)
    print(f"sparse train losses over 8 steps on one batch: "
          f"{[round(v, 6) for v in losses]}", flush=True)
    print(f"sparse train step split (warm median of 7, ms): augment {warm[0]:.3f} "
          f"forward+loss {warm[1]:.3f} backward {warm[2]:.3f} optimizer {warm[3]:.3f} "
          f"step {warm[1:].sum():.3f}; peak_device_memory_bytes {peak}", flush=True)
    _need(all(np.isfinite(losses)), f"a sparse loss is not finite: {losses}")

    # the step's parts: the model's forward, the sparse loss (its bake and
    # loop included) and its direction penalty, each forward and backward
    scale = torch.tensor(cfg["SKOOTS"]["VECTOR_SCALING"], dtype=torch.float32, device=dev)
    with torch.no_grad():
        out = model(fixed["image"])
    vec = out[..., 0:3].float().requires_grad_()
    sem = out[..., 4:5].float().requires_grad_()

    def loss_of(v, s_):
        return sum(sparse_loss(vector_to_embedding(tuple(scale.tolist()), v), v * scale,
                               fixed["points"], fixed["valid"], fixed["background"], s_,
                               init_sigma(cfg)(0), tuple(cfg["AUGMENTATION"][
                                   "BAKE_SKELETON_ANISOTROPY"]),
                               float(cfg["EXPERIMENTAL"]["DIST_THR"]),
                               float(cfg["EXPERIMENTAL"]["SPARSE_BACKGROUND_PENALTY_MULTIPLIER"])
                               )[:2])

    def backward_ms(fn):
        return _time_ms(lambda: torch.autograd.grad(fn(), fn.inputs)) - _time_ms(fn)

    parts = {}
    with torch.no_grad():
        parts["model forward"] = _time_ms(lambda: model(fixed["image"]))
    loss_fn = lambda: loss_of(vec, sem)  # noqa: E731
    loss_fn.inputs = (vec, sem)
    pen_fn = lambda: vector_direction_penalty(vec * scale).mean()  # noqa: E731
    pen_fn.inputs = (vec,)
    parts["sparse loss forward"] = _time_ms(loss_fn)
    parts["sparse loss backward"] = backward_ms(loss_fn)
    parts["direction penalty forward"] = _time_ms(pen_fn)
    parts["direction penalty backward"] = backward_ms(pen_fn)
    print(f"sparse step parts (median of {REPEATS}, ms): "
          f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}", flush=True)
    del model, opt, step, fixed, out, vec, sem

    # train_sparse: 2 epochs of SPARSE_STEPS, every launch counted
    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head,
               "upsample2x": upsample2x, "bake_skeleton": bake_skeleton_kernel}
    epochs = []

    class _Epochs(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("sparse epoch"):
                epochs.append(record.args[1])

    handler = _Epochs()
    sparse_log = logging.getLogger("skoots_tpu_torch.experimental.sparse_engine")
    sparse_log.addHandler(handler)
    level = sparse_log.level
    sparse_log.setLevel(logging.INFO)
    try:
        state, counts, wall = _drive("train_sparse", lambda: train_sparse(
            cfg, steps_per_epoch=SPARSE_STEPS, device=dev, records=records), results, kernels)
    finally:
        sparse_log.removeHandler(handler)
        sparse_log.setLevel(level)
    n, fwd = state.step, state.calibration_forwards
    per_step = {"dwconv3d": 21, "dwconv3d_wgrad": 11, "mlp_block_tail": 10, "ln_head": 1,
                "upsample2x": 2, "bake_skeleton": t["TRAIN_BATCH_SIZE"]}
    per_forward = {**{k: 0 for k in per_step}, **FORWARD_KERNELS_PER_TILE}
    print(f"train_sparse: {n} steps and {fwd} calibrator forwards in {wall:.3f} s, epoch "
          f"means {json.dumps(epochs)}", flush=True)
    print(f"train_sparse launches {json.dumps(counts)} expected {n} x "
          f"{json.dumps(per_step)} + {fwd} x {json.dumps(per_forward)}", flush=True)
    _need(len(epochs) == 2 and all(np.isfinite(e["loss"]) and e["skipped"] == 0
                                   for e in epochs), f"sparse epochs {epochs}")
    _need(n == 2 * SPARSE_STEPS and fwd >= 1, f"train_sparse ran {n} steps, {fwd} forwards")
    for name, c in counts.items():
        want = n * per_step[name] + fwd * per_forward[name]
        _need(c == want, f"train_sparse {name}: {c} launches, expected {want}")

    ckpt = load_checkpoint(state.save_name)
    extra = ckpt["extra"]
    loaded = model_from_checkpoint(ckpt, device=dev)
    x = augment(host_batches[1], gen)["image"]
    with torch.no_grad():
        same = torch.equal(state.saved_model.eval()(x), loaded(x))
    print(f"sparse checkpoint {os.path.basename(state.save_name)}: extra {json.dumps(extra)}, "
          f"reloaded forward {'equal' if same else 'DIFFERENT'}", flush=True)
    _need(same, "the reloaded sparse checkpoint's forward differs")
    _need(extra["calibrated_prob_threshold"] is not None and extra["swa"] is True,
          f"sparse checkpoint extra {extra}")
    torch.cuda.empty_cache()
    return state.save_name


def run_sparse_inference(results: list, ckpt_path: str, vol) -> None:
    """``run_inference`` with the sparse checkpoint on the ``SPARSE_BLOCK``
    block of the host phantom (``.npy`` in and out), launch counts set to 0
    just before and read just after; prints which semantic gate won, as the
    engine logs it."""
    import logging
    import shutil

    import torch

    from skoots_tpu_torch.infer import engine

    work = os.path.join(ROOT, "build", "sparse_smoke", "infer")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "block.npy")
    np.save(path, np.ascontiguousarray(vol[SPARSE_BLOCK]))
    gates = []

    class _Gate(logging.Handler):
        def emit(self, record):
            if record.msg.startswith("semantic gate"):
                gates.append(record.getMessage())

    handler = _Gate()
    engine_log = logging.getLogger(engine.__name__)
    engine_log.addHandler(handler)
    level = engine_log.level
    engine_log.setLevel(logging.INFO)
    try:
        mask, counts, wall = _drive("sparse checkpoint inference", lambda: engine.run_inference(
            path, ckpt_path, output_path=os.path.join(work, "m.npy")), results)
    finally:
        engine_log.removeHandler(handler)
        engine_log.setLevel(level)
    source = ("probe" if any("volume-calibrated" in g for g in gates) else
              "calibrated" if any("checkpoint-calibrated" in g for g in gates) else "default")
    n = len(np.unique(np.asarray(mask))) - 1
    print(f"sparse checkpoint inference on a {tuple(mask.shape)} block: semantic gate from "
          f"the {source} ({gates}), {n} instances, {wall:.3f} s, launches "
          f"{json.dumps(counts)}", flush=True)
    forwards = counts["dwconv3d"] // FORWARD_KERNELS_PER_TILE["dwconv3d"]
    _need(len(gates) == 1 and forwards >= 1
          and all(counts[k] == v * forwards for k, v in FORWARD_KERNELS_PER_TILE.items()),
          f"sparse inference: gates {gates}, launches {counts}")
    shutil.rmtree(work, ignore_errors=True)  # the checkpoint stays for run_tools
    torch.cuda.empty_cache()


# the per-slice mode's oracle: the accuracy campaign's aniso val phantom
# (make_tubes, radius 4, 10 voxels apart), scale (12, 12, 6), N = 10
ANISO_TUBES = dict(shape=(192, 192, 32), n_tubes=24, radius=4, seed=999,
                   min_separation=10.0)
ANISO_SCALE, ANISO_N = (12.0, 12.0, 6.0), 10


def run_cc_variants(results: list, ckpt, model, volume, chunked, chunked_run,
                    vol_u8) -> None:
    """The CC variants on the main path: ``make_chunked_pipeline`` on the
    512^3 bench phantom with ``bench.py``'s knobs three ways -- (a)
    ``cc_impl="sparse"``, (b) ``SKOOTS_CC_IMPL=sparse``, (c)
    ``cc_scans_per_round=1`` -- each mask equal to the dense run's voxel
    for voxel. (a) and (b) try the sparse CC at JAX's capacity and keep its
    labels when ``ok``, else run the dense CC (JAX's rule; the engine that
    ran must agree with the sparse CC's points, edges and rounds, and the
    propagate launches with that engine); (c) launches propagate
    ``len(launch_plan(192))`` times a round. Then (d) the same without the
    skeleton's dilation (a thin skeleton, the point cloud the sparse CC is
    sized for), sparse against dense: the sparse engine must label it,
    with no propagate launch. Then the thrifty pipeline under
    ``SKOOTS_CC_IMPL=sparse``, which keeps the dense CC (as the JAX
    package's) and its default mask."""
    import torch

    from skoots_tpu_torch.infer.device_pipeline import (make_chunked_pipeline,
                                                        make_thrifty_pipeline)
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.ops.flood_fill import widen_u16

    dev = torch.device("cuda")
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    knobs = dict(crop=TILE, overlap=(0, 0, 0), vector_scale=tuple(
                     ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"]),
                 embed_iterations=10, embed_exit_fraction=1e-3, embed_compact_div=16,
                 cc_rounds=24, cc_propagates_per_round=192, cc_jumps_per_round=0,
                 device=dev)
    per_round = len(prop_mod.launch_plan(192))
    n_tiles = int(np.prod([-(-v // t) for v, t in zip(VOLUME, TILE)]))
    cc_n_max = max(1 << 14, (int(np.prod(VOLUME)) // 32 + 8191) // 8192 * 8192)
    print(f"cc [dense] (the main path's run): 2-cc {chunked_run.last_phase_s['2-cc']} s, "
          f"{chunked_run.last_cc_rounds} rounds", flush=True)

    def chunked_variant(tag, ref, env=None, **kw):
        if env:
            os.environ["SKOOTS_CC_IMPL"] = env
        try:
            run = make_chunked_pipeline(model, VOLUME, assign_crop=(256, 256, 64),
                                        **knobs, **kw)
        finally:
            os.environ.pop("SKOOTS_CC_IMPL", None)
        inst, counts, dt = _drive(f"cc [{tag}]", lambda: run(volume, mean, std), results)
        same = ref is None or torch.equal(inst, ref)
        print(f"cc [{tag}]: engine {run.last_cc_impl} (sparse CC: "
              f"{json.dumps(run.last_sparse_cc)}, capacity {cc_n_max} points, "
              f"{4 * cc_n_max} edges), 2-cc {run.last_phase_s['2-cc']} s, "
              f"{run.last_cc_rounds} rounds, phases {json.dumps(run.last_phase_s)}, "
              f"{int((torch.unique(inst) > 0).sum())} instances, mask "
              f"{'equal to' if same else 'DIFFERENT from'} the dense run's", flush=True)
        _need(same, f"cc [{tag}]: the mask differs from the dense run's")
        _need(counts["dwconv3d"] == FORWARD_KERNELS_PER_TILE["dwconv3d"] * n_tiles,
              f"cc [{tag}]: {counts['dwconv3d']} dwconv launches")
        engine = run.last_cc_impl
        _need(counts["propagate"] == (0 if engine == "sparse"
                                      else run.last_cc_rounds * per_round),
              f"cc [{tag}]: {counts['propagate']} propagates, {engine} CC, "
              f"{run.last_cc_rounds} rounds")
        sp = run.last_sparse_cc
        if sp is not None:  # JAX's rule decides the engine
            fits = sp["points"] <= cc_n_max and sp["edges"] <= 4 * cc_n_max
            _need(engine == ("sparse" if sp["ok"] else "dense")
                  and (sp["ok"] or not fits or sp["rounds"] == 32),
                  f"cc [{tag}]: engine {engine} against the sparse CC's {sp}")
        return run, inst

    for tag, kw in (("cc_impl=sparse", dict(cc_impl="sparse")),
                    ("SKOOTS_CC_IMPL=sparse", dict(env="sparse"))):
        run, _ = chunked_variant(tag, chunked, **kw)
        _need(run.last_sparse_cc is not None, f"cc [{tag}]: the sparse CC was not tried")
    run, _ = chunked_variant("cc_scans_per_round=1", chunked, cc_scans_per_round=1)
    _need(run.last_cc_impl == "dense" and run.last_cc_rounds > 0, "cc [scans]: no round")
    thin = dict(dilation_3d=0, dilation_2d=0)
    _, ref = chunked_variant("dense, no dilation", None, **thin)
    run, _ = chunked_variant("cc_impl=sparse, no dilation", ref, cc_impl="sparse", **thin)
    _need(run.last_cc_impl == "sparse",
          f"cc [sparse, no dilation]: the sparse CC fell back ({run.last_sparse_cc})")
    del run, ref
    torch.cuda.empty_cache()

    masks = []
    for env in (None, "sparse"):
        if env:
            os.environ["SKOOTS_CC_IMPL"] = env
        try:
            run = make_thrifty_pipeline(model, VOLUME, assign_crop=ASSIGN_TILE, **knobs)
        finally:
            os.environ.pop("SKOOTS_CC_IMPL", None)
        tag = f"thrifty [SKOOTS_CC_IMPL={env or 'unset'}]"
        inst, counts, _ = _drive(tag, lambda: run(vol_u8, mean, std), results)
        masks.append(widen_u16(inst))
        print(f"{tag}: phases {json.dumps(run.last_phase_s)}, {run.last_cc_rounds} CC "
              f"rounds, {run.last_count} components", flush=True)
        _need(counts["propagate"] == run.last_cc_rounds * per_round > 0,
              f"{tag}: {counts['propagate']} propagates, {run.last_cc_rounds} rounds")
        del inst, run
        torch.cuda.empty_cache()
    _need(torch.equal(masks[0], masks[1]), "thrifty under SKOOTS_CC_IMPL=sparse: the mask "
          "differs from its default one")
    print("thrifty [SKOOTS_CC_IMPL=sparse]: mask equal to its default one", flush=True)


def run_perslice_slice(results: list, vol, n_default: int) -> None:
    """This slice's host-cell phases on the 256^3 phantom with the bench
    checkpoint at full width:

    1. ``run_perslice_inference`` on a copy without phase-1 buffers (the
       host engine runs once, every forward kernel per forward of the host
       cell), then again on the buffers it left (no forward): the masks
       equal, propagate launched once per per-slice CC round (and per 3D CC
       round in the first run); the assign / stitch seconds and the
       instance count beside the 3D engine's;
    2. ``perslice_segment`` on the card against the CPU's plain versions on
       the same buffers, voxel for voxel; the propagate kernel against its
       plain version at the per-slice layout ``[2Z - 1, X, Y]`` (one pass);
    3. the host engine with ``use_cached_data``, by default and under
       ``SKOOTS_CC_IMPL=sparse``: masks equal, the tiles each CC engine
       labelled;
    4. the oracle on the campaign's aniso val phantom: the bake kernel
       against its plain version at ``perfect_prediction``'s inputs (0
       values differing), ``perfect_prediction`` on the card (one bake
       launch, counted from 0), ``perslice_segment`` at scale (12, 12, 6),
       N = 10: 21 of 21 at IoU 0.5, no false positive."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer import engine, perslice
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel, bake_skeleton_ref
    from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref
    from skoots_tpu_torch.ops.skeleton import pack_skeletons
    from skoots_tpu_torch.tools.bench_propagate import sparse_bound_ms
    from skoots_tpu_torch.utils.synthetic import make_tubes, perfect_prediction
    from skoots_tpu_torch.validate.metrics import accuracies_from_iou, mask_iou

    dev = torch.device("cuda")
    ckpt = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    work = os.path.join(ROOT, "build", "perslice_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol)
    stem = os.path.splitext(path)[0]

    # 1. the per-slice mode from scratch, then on its cached buffers
    first, counts, dt = _drive("perslice [from scratch]",
                               lambda: perslice.run_perslice_inference(path, ckpt), results)
    stats = json.loads(json.dumps(engine.last_stats))
    rounds = perslice.perslice_label_components.last_rounds
    split = dict(perslice.perslice_segment.last_phase_s)
    forwards = 4 + stats["phase1"]["tiles"]
    for name, k in FORWARD_KERNELS_PER_TILE.items():
        _need(counts[name] == k * forwards,
              f"perslice {name}: {counts[name]} launches, expected {k} x {forwards}")
    _need(counts["propagate"] == stats["phase2"]["cc_rounds"] + rounds,
          f"perslice propagate: {counts['propagate']} launches, expected "
          f"{stats['phase2']['cc_rounds']} 3D + {rounds} per-slice CC rounds")
    cached, counts, dt_cached = _drive(
        "perslice [cached]", lambda: perslice.run_perslice_inference(path, ckpt), results)
    split_cached = dict(perslice.perslice_segment.last_phase_s)
    n = len(np.unique(first)) - 1
    print(f"perslice: from scratch {dt:.3f} s (assign {split['assign']} s, stitch "
          f"{split['stitch']} s), cached {dt_cached:.3f} s (assign {split_cached['assign']} "
          f"s, stitch {split_cached['stitch']} s); {rounds} per-slice CC rounds; {n} "
          f"instances (3D engine {n_default})", flush=True)
    _need(all(counts[k] == 0 for k in FORWARD_KERNELS_PER_TILE),
          "the cached per-slice run ran the model")
    _need(counts["propagate"] == rounds > 0, f"perslice [cached]: {counts['propagate']} "
          f"propagates, {rounds} rounds")
    _need(np.array_equal(first, cached), "the cached per-slice mask differs")
    _need(n >= 1, "the per-slice mode found no instance")

    # 2. card vs CPU on the same buffers; propagate at the per-slice layout
    bufs = [np.load(f"{stem}_skoots_{b}.npy", mmap_mode="r")
            for b in ("vectors", "skeleton", "semantic")]
    scale = tuple(load_checkpoint(ckpt)["cfg"]["SKOOTS"]["VECTOR_SCALING"])
    card, _, _ = _drive("perslice_segment [card]",
                        lambda: perslice.perslice_segment(*bufs, scale, 10), results)
    t0 = time.time()
    cpu = perslice.perslice_segment(*bufs, scale, 10, device="cpu")
    print(f"perslice_segment [cpu]: {time.time() - t0:.3f} s "
          f"({json.dumps(perslice.perslice_segment.last_phase_s)}); card "
          f"{'equal to' if np.array_equal(card, cpu) else 'DIFFERENT from'} cpu", flush=True)
    _need(np.array_equal(card, cpu) and np.array_equal(card, cached),
          "perslice_segment on the card differs from the CPU's or the run's")
    skel = torch.from_numpy(np.ascontiguousarray(np.moveaxis(bufs[1] > 0, 2, 0))).to(dev)
    z, x, y = skel.shape
    fg = torch.zeros((2 * z - 1, x, y), dtype=torch.uint8, device=dev)
    fg[0::2] = skel
    idx = torch.arange(1, fg.numel() + 1, dtype=torch.int32, device=dev).view(fg.shape)
    lab = torch.where(fg > 0, idx, 0)
    got, ref = propagate(lab, fg, passes=1), propagate_ref(lab, fg)
    torch.cuda.synchronize()
    err = float((got != ref).sum())
    _record(results, "propagate", "skoots_tpu_torch/csrc/propagate.cu",
            "skoots_tpu/kernels/propagate.py:93", err, err, 0.0,
            f"voxels differing at the per-slice layout {tuple(fg.shape)}, 1 pass, "
            f"{int(fg.sum())} fg voxels",
            _time_ms(lambda: propagate(lab, fg, passes=1)),
            _time_ms(lambda: propagate_ref(lab, fg)), (sparse_bound_ms(fg, 1), "bytes"))
    del skel, fg, idx, lab, got, ref

    # 3. the host engine's CC tiles, dense and sparse, from the cached buffers
    masks = []
    for env in (None, "sparse"):
        if env:
            os.environ["SKOOTS_CC_IMPL"] = env
        tag = f"host engine [use_cached, SKOOTS_CC_IMPL={env or 'unset'}]"
        try:
            mask, counts, _ = _drive(tag, lambda: engine.run_inference(
                path, ckpt, use_cached_data=True,
                output_path=os.path.join(work, f"mask_{env}.npy")), results)
        finally:
            os.environ.pop("SKOOTS_CC_IMPL", None)
        p2 = engine.last_stats["phase2"]
        print(f"{tag}: phase 2 {p2['total_s']} s, tiles {json.dumps(p2['cc_tiles'])}, "
              f"{p2['cc_rounds']} dense rounds, {len(np.unique(mask)) - 1} instances",
              flush=True)
        _need(counts["propagate"] == p2["cc_rounds"], f"{tag}: propagate launches")
        _need(p2["cc_tiles"]["sparse"] > 0 if env else p2["cc_tiles"]["sparse"] == 0,
              f"{tag}: tiles {p2['cc_tiles']}")
        masks.append(np.asarray(mask))
    _need(np.array_equal(masks[0], masks[1]),
          "the host engine's sparse-CC mask differs from its default one")
    print("host engine [SKOOTS_CC_IMPL=sparse]: mask equal to the default one", flush=True)
    shutil.rmtree(work, ignore_errors=True)

    # 4. the oracle on the aniso val phantom: the bake against its plain
    #    version at perfect_prediction's inputs (the phantom's labels and
    #    packed skeletons, anisotropy 1, exact), then perfect_prediction and
    #    the per-slice mode on the card
    _, labels, skels = make_tubes(**ANISO_TUBES)
    packed = pack_skeletons(skels, dev)
    masks = torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int32)).to(dev)
    pts, ids = packed.points, packed.ids
    got = bake_skeleton_kernel(masks, pts, ids)
    ref = bake_skeleton_ref(masks, pts, ids)
    torch.cuda.synchronize()
    diff = int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
    _record(results, "bake_skeleton", "skoots_tpu_torch/csrc/bake.cu",
            "skoots_tpu/kernels/bake.py:112", float(diff),
            max(float((a - b).abs().max()) for a, b in zip(got, ref)), 0.0,
            f"values differing at the aniso oracle {tuple(masks.shape)} P={pts.shape[0]}",
            _time_ms(lambda: bake_skeleton_kernel(masks, pts, ids)),
            _time_ms(lambda: bake_skeleton_ref(masks, pts, ids)),
            bake_bound(masks, pts, ids, *got))
    del packed, masks, pts, ids, got, ref
    pred, counts, _ = _drive(
        "perfect_prediction", lambda: perfect_prediction(labels, skels, ANISO_SCALE), results,
        {**_launch_counters(), "bake_skeleton": bake_skeleton_kernel})
    _need(counts["bake_skeleton"] == 1, f"perfect_prediction: {counts} launches")
    out, counts, dt = _drive("perslice oracle", lambda: perslice.perslice_segment(
        pred[..., 0:3], (pred[..., 3] > 0.5).astype(np.uint8),
        (pred[..., 4] > 0.5).astype(np.uint8), ANISO_SCALE, ANISO_N), results)
    tp, fp, fn = accuracies_from_iou(mask_iou(labels, out, device=dev).cpu(), 0.5)
    n_gt = len(np.unique(labels)) - 1
    print(f"perslice oracle (make_tubes {json.dumps(ANISO_TUBES)}, scale {ANISO_SCALE}, "
          f"N = {ANISO_N}): {n_gt} ground-truth instances, {len(np.unique(out)) - 1} "
          f"predicted, tp {tp} fp {fp} fn {fn} at IoU 0.5; "
          f"{json.dumps(perslice.perslice_segment.last_phase_s)}", flush=True)
    _need(n_gt == 21 and (tp, fp, fn) == (21, 0, 0),
          f"the aniso oracle: {n_gt} instances, tp {tp} fp {fp} fn {fn}")
    _need(counts["propagate"] == perslice.perslice_label_components.last_rounds > 0,
          "the oracle's per-slice CC did not run on the propagate kernel")
    torch.cuda.empty_cache()


# launches of each kernel in one forward of the accuracy campaign's model
# (the stem and 5 blocks, all at widths the fused tail and head take, 2
# upsamples), and what a training step adds (5 input gradients, 6 weight
# gradients, a bake a sample)
CAMPAIGN_PER_FORWARD = {"dwconv3d": 6, "mlp_block_tail": 5, "ln_head": 1, "upsample2x": 2}
CAMPAIGN_PER_STEP = {"dwconv3d": 5, "dwconv3d_wgrad": 6}


def _campaign_model_launches(steps: int, epochs: int, panels: bool, bsz: int,
                             stats: dict) -> dict:
    """Launches of the campaign model's ``steps`` training steps (and a
    panel forward an epoch where TensorBoard imports) and one
    ``run_inference`` after them (the dilation probe's forwards and phase
    1's tiles, propagate once a CC round; ``stats`` is its
    ``engine.last_stats``), by kernel."""
    tiles = stats["phase1"]["tiles"]
    forwards = steps + (epochs if panels else 0) + min(4, tiles) + tiles
    want = {name: k * forwards + CAMPAIGN_PER_STEP.get(name, 0) * steps
            for name, k in CAMPAIGN_PER_FORWARD.items()}
    want.update(dwconv3d_wgrad=CAMPAIGN_PER_STEP["dwconv3d_wgrad"] * steps,
                bake_skeleton=bsz * steps, propagate=stats["phase2"]["cc_rounds"])
    return want


def _tensorboard_panels() -> bool:
    """Whether the training loop writes its panels (a forward an epoch):
    only where TensorBoard imports."""
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        return True
    except ImportError:
        return False


def run_campaign(results: list) -> str:
    """The accuracy campaign's ``separated`` scenario at the tool's defaults
    (150 epochs of 10 steps, the campaign model at widths 16-32-64) through
    ``tools/accuracy_campaign.py::run_scenario`` on the card: the phantoms,
    ``skoots-train-torch``, ``run_inference`` and the score. Every kernel of
    its training and inference is counted from 0 (the plain propagation
    barred): per training step and per forward (the training panels' one
    an epoch where TensorBoard is installed, the dilation probe's, phase
    1's tiles), propagate once a CC round. F1 at IoU 0.5 must reach 0.8.
    Then :func:`check_campaign_propagate` on the run's stored skeleton.
    Returns the campaign's outdir (its checkpoint is scored again by
    :func:`run_tools`)."""
    from skoots_tpu_torch.config import load_cfg_from_file
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad
    from skoots_tpu_torch.tools import accuracy_campaign as ac

    panels = _tensorboard_panels()
    outdir = os.path.join(ROOT, "build", "campaign_smoke")
    shutil.rmtree(outdir, ignore_errors=True)
    epochs, steps_per_epoch = 150, 10
    kernels = {**_launch_counters(), "dwconv3d_wgrad": dwconv3d_wgrad,
               "bake_skeleton": bake_skeleton_kernel}
    with _stem_routes("campaign [separated]", CAMPAIGN_STEM_ROUTES):
        result, counts, wall = _drive("campaign [separated]", lambda: ac.run_scenario(
            "separated", outdir, epochs, steps_per_epoch, device="cuda"), results, kernels)
    stats = engine.last_stats
    bsz = load_cfg_from_file(os.path.join(outdir, "separated", "cfg.yaml"))["TRAIN"][
        "TRAIN_BATCH_SIZE"]
    steps = result["steps"]
    tiles = stats["phase1"]["tiles"]
    want = _campaign_model_launches(steps, epochs, panels, bsz, stats)
    print(f"campaign [separated]: F1@0.5 {result['f1_at_iou50']} (bar 0.8), mean IoU "
          f"{result['mean_iou']}, {result['pred_instances']} of {result['gt_instances']} "
          f"instances, {steps} steps, {wall:.1f} s; launches expected "
          f"{json.dumps(want)} (panels {panels}, {tiles} tile(s))", flush=True)
    _need(steps == epochs * steps_per_epoch, f"campaign: {steps} steps trained")
    for name, c in counts.items():
        _need(c > 0, f"campaign: kernel {name} was not launched")
        _need(c == want[name], f"campaign: {name} {c} launches, expected {want[name]}")
    _need(result["f1_at_iou50"] >= 0.8, f"campaign: separated F1 {result['f1_at_iou50']}")
    check_campaign_propagate(
        results, os.path.join(outdir, "separated", "val", "val_skoots_skeleton.npy"),
        tuple(stats["phase2"]["cc_crop"]), stats["phase2"]["cc_rounds"])
    return outdir


def check_campaign_propagate(results: list, skel_path: str, cc_crop: tuple,
                             cc_rounds: int) -> None:
    """Propagate against its plain version at the campaign's phase-2 input:
    the validation volume's stored skeleton, cut into the engine's CC tiles
    (``cc_crop``), and every round's labels as ``label_components`` makes
    them (one pass a round, then the pointer jumps from the kernel's labels)
    up to the fixpoint. Exact: 0 voxels differing over all rounds; the
    rounds must be the run's ``cc_rounds``. Times: one pass on the first
    round's labels."""
    import torch

    from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref
    from skoots_tpu_torch.ops.cropper import crop_origins, effective_crop_size
    from skoots_tpu_torch.ops.flood_fill import _init_labels, _one_round
    from skoots_tpu_torch.tools.bench_propagate import sparse_bound_ms

    skel = np.load(skel_path)
    crop = effective_crop_size(skel.shape, cc_crop)
    differing, rounds, first = 0, 0, None
    for origin in crop_origins(skel.shape, crop, (0, 0, 0)):
        sl = tuple(slice(o, o + c) for o, c in zip(origin, crop))
        fg, lab = _init_labels(torch.from_numpy(np.ascontiguousarray(skel[sl] > 0)).cuda())
        first = first or (fg, lab)
        for _ in range(64):  # label_components' max_rounds
            got, ref = propagate(lab, fg, passes=1), propagate_ref(lab, fg)
            differing += int((got != ref).sum())
            new = _one_round(fg, lab, 26, 1, 2)
            rounds += 1
            if torch.equal(new, lab):
                break
            lab = new
    fg, lab = first
    _record(results, "propagate", "skoots_tpu_torch/csrc/propagate.cu",
            "skoots_tpu/kernels/propagate.py:93", float(differing), float(differing), 0.0,
            f"voxels differing at the campaign's CC tiles {crop} of {skel.shape}, 1 pass "
            f"a round, {rounds} rounds, {int(fg.sum())} fg voxels",
            _time_ms(lambda: propagate(lab, fg, passes=1)),
            _time_ms(lambda: propagate_ref(lab, fg)), (sparse_bound_ms(fg, 1), "bytes"))
    _need(rounds == cc_rounds, f"campaign CC: {rounds} rounds here, {cc_rounds} in the run")


SHARDED_VOLUME = (254, 256, 256)  # X not a multiple of lcm(4, n) for n = 1, 2, 4
SHARDED_MESHES = (1, 2, 4)
SHARDED_MODES = (("ring", "ring"), ("ring", "replicated"), ("replicated", "replicated"))
# a second volume, the phantom's first 126 planes, whose reserved peak the
# estimate must hold too (the factor RESERVED_PER_LIVE_BYTE was fitted on
# SHARDED_VOLUME)
SHARDED_SECOND_X = 126
# timing repeats of the kernel checks at the sharded runs' operand shapes
# (the largest are whole 256^3 volumes, whose plain versions take seconds)
SHARDED_REPEATS = 3


@contextlib.contextmanager
def _kernel_operands(seen: dict, cc=None):
    """While open, record the operands of every launch of the forward
    kernels and of propagate as the CC module ``cc`` calls it (by default
    the sharded CC's, ``infer/sharded.py``): ``seen[name]`` a set of the
    ``_check_*`` arguments (shapes, channels, k, dtype), and
    ``seen["propagate"]`` a copy of the first labels and mask of each
    (shape, passes). Each wrapper still launches once a call."""
    import torch

    from skoots_tpu_torch.infer import sharded
    from skoots_tpu_torch.kernels import dwconv, lnhead, mlp, upsample

    cc = cc or sharded

    def dtn(t):
        return "bf16" if t.dtype == torch.bfloat16 else "f32"

    saved = {(dwconv, "_dwconv3d_fwd"): None, (mlp, "_mlp_fwd"): None,
             (lnhead, "_ln_head_fwd"): None, (upsample, "_upsample2x_fwd"): None,
             (cc, "propagate"): None}
    for key in saved:
        saved[key] = getattr(*key)
    for name in ("dwconv3d", "mlp_block_tail", "ln_head", "upsample2x"):
        seen.setdefault(name, set())
    seen.setdefault("propagate", {})

    def dw(x, w, b):
        seen["dwconv3d"].add((tuple(x.shape[:-1]), x.shape[-1], w.shape[-1], w.shape[0],
                              dtn(x)))
        return saved[dwconv, "_dwconv3d_fwd"](x, w, b)

    def tail(x, *args):
        seen["mlp_block_tail"].add((x.numel() // x.shape[-1], x.shape[-1], dtn(x)))
        return saved[mlp, "_mlp_fwd"](x, *args)

    def head(x, ls, lb, w, b):
        seen["ln_head"].add((x.numel() // x.shape[-1], x.shape[-1], w.shape[-1], dtn(x)))
        return saved[lnhead, "_ln_head_fwd"](x, ls, lb, w, b)

    def up(x):
        seen["upsample2x"].add((tuple(x.shape), x.dtype))
        return saved[upsample, "_upsample2x_fwd"](x)

    def prop(labels, fg, passes=4, **kwargs):
        key = (tuple(labels.shape), passes)
        if key not in seen["propagate"]:
            seen["propagate"][key] = (labels.clone(), fg.clone())
        return saved[cc, "propagate"](labels, fg, passes=passes, **kwargs)

    for (mod, attr), fn in zip(saved, (dw, tail, head, up, prop)):
        setattr(mod, attr, fn)
    try:
        yield seen
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _check_sharded_kernels(results: list, seen: dict, cc_input: str = "a sharded CC chunk"
                           ) -> None:
    """Every kernel at every operand shape a driven run gave it
    (:func:`_kernel_operands`), against its plain version at the bounds
    of :func:`check_kernels`: the forward kernels on seeded inputs drawn
    on the card, the CC's propagate on the labels and mask it labelled
    (``cc_input`` names them; 0 voxels differing; least time as row 4b's)."""
    import torch

    from skoots_tpu_torch.kernels.propagate import propagate, propagate_ref
    from skoots_tpu_torch.tools.bench_propagate import sparse_bound_ms

    r = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for case in sorted(seen["dwconv3d"]):
        _check_dwconv(results, r, *case, repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
    for case in sorted(seen["mlp_block_tail"]):
        _check_tail(results, r, *case, repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
    for case in sorted(seen["ln_head"]):
        _check_ln_head(results, r, *case, repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
    for shape, dt in sorted(seen["upsample2x"], key=str):
        _check_upsample(results, r, shape, dt, repeats=SHARDED_REPEATS)
        torch.cuda.empty_cache()
    for (shape, passes), (lab, fg) in sorted(seen["propagate"].items()):
        def plain(lab=lab, fg=fg, passes=passes):
            out = lab
            for _ in range(passes):
                out = propagate_ref(out, fg)
            return out

        got = propagate(lab, fg, passes=passes)
        differing = float((got != plain()).sum())
        _record(results, "propagate", "skoots_tpu_torch/csrc/propagate.cu",
                "skoots_tpu/kernels/propagate.py:93", differing, differing, 0.0,
                f"voxels differing on {cc_input} {shape}, {passes} passes, "
                f"{int(fg.sum())} fg voxels",
                _time_ms(lambda: propagate(lab, fg, passes=passes), SHARDED_REPEATS),
                _time_ms(plain, SHARDED_REPEATS), (sparse_bound_ms(fg, passes), "bytes"))
    seen.clear()
    torch.cuda.empty_cache()


def run_sharded(results: list) -> None:
    """The sharded pipeline (``infer/sharded.py``) with the bench checkpoint
    at full width (bf16) on a seeded ``SHARDED_VOLUME`` tube phantom (uint8
    host array) over meshes of 1, 2 and 4 slabs, all on this one card
    (``make_mesh(1, n, ["cuda:0"] * n)``), each driven through
    ``make_sharded_pipeline(...)(volume)`` with the launch counts set to 0
    just before and read just after: every forward kernel once a slab a
    module, propagate ``len(launch_plan(q))`` a slab a halo exchange ``q``
    a CC round, the plain propagation barred. Prints the phase times, the
    reserved peak a voxel beside the estimate (which must hold it: on this
    volume that check is the point ``RESERVED_PER_LIVE_BYTE`` was fitted
    to, not a test of it; the first ``SHARDED_SECOND_X`` planes at 1 and 4
    slabs are the check at a volume it was not fitted to), the forward's
    bitwise-equal share against 1 slab (decisions >= 0.995), the
    instance count inside the phantom's bar and the agreement with 1 slab
    (>= 0.99). Then the CC
    and assignment of 2 and 4 slabs on the 1-slab forward's outputs, for
    both label gathers and both walks, equal to 1 slab's exactly; every
    kernel at every operand shape the driven runs gave it against its plain
    version (:func:`_check_sharded_kernels`); and
    ``run_inference(spatial_shards=2)`` raising JAX's "needs that many
    devices" on this one-card machine, while auto resolves to 0."""
    import torch

    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.infer import engine, sharded
    from skoots_tpu_torch.kernels import propagate as prop_mod
    from skoots_tpu_torch.models import model_from_checkpoint
    from skoots_tpu_torch.parallel import make_mesh
    from skoots_tpu_torch.utils.device import resolve_devices
    from skoots_tpu_torch.utils.synthetic import render_tubes, tube_segments

    ckpt_path = os.path.join(ROOT, "runs", "bench_ckpt.skoots")
    ckpt = load_checkpoint(ckpt_path)
    model = model_from_checkpoint(ckpt, device="cuda")
    mean, std = float(ckpt["dataset_mean"]), float(ckpt["dataset_std"])
    scale = tuple(ckpt["cfg"]["SKOOTS"]["VECTOR_SCALING"])
    shape = SHARDED_VOLUME
    vox = int(np.prod(shape))
    n_target = max(6, int(48 * vox / 512**3))
    p0, p1, n_expected = tube_segments(shape, n_target, radius=5.0, seed=7)
    vol = render_tubes(shape, p0, p1, radius=5.0, device="cuda").round()
    vol = vol.to(torch.uint8).cpu().numpy()
    fwd_bpv = engine._forward_bytes_per_voxel(model, 0.8, torch.device("cuda"))
    print(f"sharded: phantom {shape} uint8, {n_expected} tubes placed; forward probe "
          f"{engine.FORWARD_PROBE}: {fwd_bpv} bytes a voxel ({engine.RESERVED_PER_LIVE_BYTE} x "
          "its live peak)", flush=True)

    # one undriven 1-slab run first, so each driven run's phases are warm
    sharded.make_sharded_pipeline(model, make_mesh(1, 1, ["cuda:0"]), shape,
                                  vector_scale=scale)(vol, mean, std)
    ref, seen = {}, {}
    for n in SHARDED_MESHES:
        mesh = make_mesh(1, n, ["cuda:0"] * n)
        run = sharded.make_sharded_pipeline(model, mesh, shape, vector_scale=scale)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        with _kernel_operands(seen):
            inst, counts, wall = _drive(f"sharded [{n} slab(s)]",
                                        lambda: run(vol, mean, std), results)
        reserved = torch.cuda.max_memory_reserved() - base
        # one card holds every slab: n devices' estimates
        est = n * sharded.estimated_bytes_per_device(shape, n, run.walk_gather, fwd_bpv)
        per_round = sum(len(prop_mod.launch_plan(q)) for q in run.cc.hop_chunks)
        want = {k: v * n for k, v in FORWARD_KERNELS_PER_TILE.items()}
        want["propagate"] = run.cc.last_rounds * n * per_round
        n_inst = len(np.unique(inst)) - 1
        print(f"sharded [{n}]: slabs {run.bounds} of the padded {run.padded_shape}, walk "
              f"{run.walk_gather}, phases {json.dumps(run.last_phase_s)}, e2e {wall:.3f} s; "
              f"CC {run.cc.last_rounds} rounds of {run.cc.hop_chunks} hops a halo exchange; "
              f"{n_inst} instances of {n_expected} placed; reserved peak {reserved} B = "
              f"{reserved / vox:.1f} B a voxel, estimate {est / vox:.1f} B a voxel "
              f"(n x estimated_bytes_per_device with the forward's {fwd_bpv})", flush=True)
        _need(counts == want, f"sharded [{n}]: launches {counts}, expected {want}")
        _need(reserved <= est, f"sharded [{n}]: reserved {reserved} B above the estimate {est}")
        _need(0.8 * n_expected <= n_inst <= n_expected + 4,
              f"sharded [{n}]: {n_inst} instances outside [0.8*{n_expected}, {n_expected}+4]")
        vec, packed = run.fwd(sharded.shard_volume(
            np.pad(vol.astype(np.float32), [(0, p - d) for p, d in zip(run.padded_shape, shape)],
                   mode="reflect"), mesh, 0, run.bounds), mean, std)
        vec, packed = vec.whole(), packed.whole()
        if n == 1:
            ref = {"vec": vec, "packed": packed, "inst": inst, "run": run}
            continue
        vec_eq = float((vec.view(torch.int16) == ref["vec"].view(torch.int16)).all(-1)
                       .float().mean())
        dec = {b: float((((packed >> b) & 1) == ((ref["packed"] >> b) & 1)).float().mean())
               for b in (0, 1)}
        agree = float((inst == ref["inst"]).mean())
        fg = (inst > 0) | (ref["inst"] > 0)
        agree_fg = float((inst == ref["inst"])[fg].mean())
        print(f"sharded [{n}] vs 1 slab: vectors bitwise equal at {vec_eq:.6f} of the voxels, "
              f"decisions (bit 0, bit 1) {dec[0]:.6f}, {dec[1]:.6f}; instances equal at "
              f"{agree:.6f} of the voxels ({agree_fg:.6f} of the foreground)", flush=True)
        _need(min(dec.values()) >= 0.995, f"sharded [{n}]: decisions agree at {dec}")
        _need(agree >= 0.99, f"sharded [{n}]: instances agree at {agree}")

    # the CC and the assignment on identical inputs: exactly 1 slab's
    labels1 = ref["run"].cc(ref["packed"]).whole()
    inst1 = ref["run"].assign(labels1, ref["vec"], ref["packed"]).whole()
    for n in SHARDED_MESHES[1:]:
        mesh = make_mesh(1, n, ["cuda:0"] * n)
        for lg, wg in SHARDED_MODES:
            run = sharded.make_sharded_pipeline(model, mesh, shape, vector_scale=scale,
                                                label_gather=lg, walk_gather=wg)
            labels = run.cc(ref["packed"])
            inst = run.assign(labels, ref["vec"], ref["packed"])
            same = torch.equal(labels.whole(), labels1) and torch.equal(inst.whole(), inst1)
            print(f"sharded [{n}] {lg} labels / {wg} walk on the 1-slab forward: CC "
                  f"{run.cc.last_rounds} rounds, labels and instances "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
            _need(same, f"sharded [{n}] {lg}/{wg}: CC or assignment differs from 1 slab's")
    del labels1, inst1, labels, inst, run
    ref.pop("run")

    # the estimate at a volume its factor was not fitted to
    second = np.ascontiguousarray(vol[:SHARDED_SECOND_X])
    for n in (1, 4):
        run = sharded.make_sharded_pipeline(model, make_mesh(1, n, ["cuda:0"] * n),
                                            second.shape, vector_scale=scale)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        run(second, mean, std)
        torch.cuda.synchronize()
        reserved = torch.cuda.max_memory_reserved() - base
        est = n * sharded.estimated_bytes_per_device(second.shape, n, run.walk_gather, fwd_bpv)
        sv = second.size
        print(f"sharded [{n}] {second.shape}: reserved peak {reserved} B = "
              f"{reserved / sv:.1f} B a voxel, estimate {est / sv:.1f} B a voxel", flush=True)
        _need(reserved <= est, f"sharded [{n}] {second.shape}: reserved {reserved} B above "
              f"the estimate {est}")
    del run, second
    torch.cuda.empty_cache()

    _check_sharded_kernels(results, seen)

    # run_inference on this one-card machine: 2 shards raise, auto picks 0
    work = os.path.join(ROOT, "build", "sharded_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "phantom.npy")
    np.save(path, vol)
    try:
        engine.run_inference(path, ckpt_path, spatial_shards=2)
        raised = ""
    except ValueError as e:
        raised = str(e)
    _, devices = resolve_devices("cuda")
    auto = sharded.resolve_spatial_shards(None, len(devices), shape,
                                          sharded.device_bytes_limit(devices[0]))
    print(f"run_inference(spatial_shards=2) on {len(devices)} card(s): raised {raised!r}; "
          f"auto resolves to {auto}", flush=True)
    _need("needs that many devices, have 1" in raised and auto == 0,
          "run_inference's shard resolution on one card")
    shutil.rmtree(work, ignore_errors=True)
    del model, ref
    torch.cuda.empty_cache()


def run_dp_train(results: list, records) -> None:
    """Data-parallel training over ``make_mesh(2, 1, ["cuda:0"] * 2)`` at
    the training cell: one f32 step of batch 2 (dice as the embedding
    loss, DropPath 0.1: the masks drawn for the whole batch) against the
    one-device step from the same weights (loss 1e-4 relative, every
    gradient 1e-3 * max), then 8 bf16 steps of the cell's cfg at batch 2 on
    one augmented batch with the launches counted (every kernel once a
    shard), the loss falling. Then ``setup_process`` with NCCL at world
    size 1 and a broadcast from process 0."""
    import torch

    from skoots_tpu_torch.kernels.dwconv import dwconv3d, dwconv3d_wgrad
    from skoots_tpu_torch.kernels.lnhead import ln_head
    from skoots_tpu_torch.kernels.mlp import mlp_block_tail
    from skoots_tpu_torch.kernels.upsample import upsample2x
    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.parallel import distributed, make_mesh
    from skoots_tpu_torch.train.engine import (
        cfg_optimizer,
        drop_path_generator,
        make_train_step,
    )
    from skoots_tpu_torch.train.sigma import init_sigma

    base, augment, host_batches, _, _ = _train_cell(records)
    gen = torch.Generator().manual_seed(base["TRAIN"]["SEED"])
    one = [augment(host_batches[i], gen) for i in range(2)]
    batch = {k: torch.cat([b[k] for b in one]) for k in one[0]}
    mesh = make_mesh(2, 1, ["cuda:0"] * 2)

    runs = []
    for m in (None, mesh):
        cfg = _bench_train_cfg()
        cfg["MODEL"].update(DTYPE="float32", DROP_PATH_RATE=0.1)
        cfg["TRAIN"].update(LOSS_EMBED="dice", TRAIN_BATCH_SIZE=2)
        model = init_model(cfg, SEED, device="cuda").train()
        opt, sched = cfg_optimizer(cfg, model.parameters())
        step = make_train_step(model, opt, sched, init_sigma(cfg), cfg, m)
        total, _ = step.loss_fn(batch, 1, drop_path_generator(SEED, 0))
        total.backward()
        runs.append((float(total.detach()), {n: p.grad.float() for n, p in
                                             model.named_parameters()}))
    (l1, g1), (l2, g2) = runs
    worst = max(float((g2[n] - g1[n]).abs().max()) / max(float(g1[n].abs().max()), 1e-30)
                for n in g1)
    print(f"data-parallel f32 step (2 x batch 1 on cuda:0 twice) vs one device at batch 2: "
          f"loss {l2:.8g} vs {l1:.8g} (rel {abs(l2 - l1) / abs(l1):.3g}, bound 1e-4); "
          f"worst gradient {worst:.3g} of its max (bound 1e-3)", flush=True)
    _need(abs(l2 - l1) <= 1e-4 * abs(l1) and worst <= 1e-3,
          "the data-parallel step differs from the one-device step")

    cfg = _bench_train_cfg()
    cfg["TRAIN"]["TRAIN_BATCH_SIZE"] = 2
    model = init_model(cfg, SEED, device="cuda").train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg, mesh)
    with torch.no_grad():
        first = float(step.loss_fn(batch, 0)[0])
    kernels = {"dwconv3d": dwconv3d, "dwconv3d_wgrad": dwconv3d_wgrad,
               "mlp_block_tail": mlp_block_tail, "ln_head": ln_head, "upsample2x": upsample2x}

    def eight_steps():
        times = []
        for _ in range(8):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step(batch, 0)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return times

    times, counts, _ = _drive("data-parallel train (2 shards)", eight_steps, results, kernels)
    with torch.no_grad():
        final = float(step.loss_fn(batch, 0)[0])
    # a shard: 11 dwconv forwards and 10 input gradients, 11 weight
    # gradients, 10 block tails, 1 LN head, 2 upsamples
    want = {k: 8 * 2 * v for k, v in {"dwconv3d": 21, "dwconv3d_wgrad": 11,
                                      "mlp_block_tail": 10, "ln_head": 1,
                                      "upsample2x": 2}.items()}
    print(f"data-parallel bf16 steps (ms): {[round(t, 3) for t in times]}, warm median "
          f"{np.median(times[1:]):.3f}; loss {first:.6f} -> {final:.6f}", flush=True)
    _need(counts == want, f"data-parallel launches {counts}, expected {want}")
    _need(np.isfinite(final) and final < first, "the data-parallel loss did not fall")

    port = distributed.find_free_port()
    rank = distributed.setup_process(f"127.0.0.1:{port}", 1, 0)  # NCCL on a card
    try:
        _need(torch.distributed.is_initialized() and rank == 0, "NCCL did not initialise")
        got = distributed.broadcast_from_host0(np.array([3, 1, 4], np.int64))
    finally:
        distributed.cleanup()
    print(f"setup_process (nccl, world size 1): rank {rank}, broadcast {got.tolist()}",
          flush=True)
    _need(got.tolist() == [3, 1, 4], "the broadcast from process 0 differs")
    del model, opt, step
    torch.cuda.empty_cache()


TOOLS_CONVERGENCE = (2, 2)  # epochs, steps an epoch: the tool's whole path, not its bars


def _tools_sparse_dir(path: str, vols) -> str:
    """The sparse training phase's volumes in the file contract of
    ``experimental/data.py`` (``<name>.tif``, ``.background.tif``,
    ``.skeletons.npz``, named as its in-memory records): the same records
    read back."""
    from scipy import ndimage

    from skoots_tpu_torch.train.generate_skeletons import save_skeletons
    from skoots_tpu_torch.utils.io import imsave

    os.makedirs(path, exist_ok=True)
    for i, (img, labels, skels) in enumerate(vols):
        base = os.path.join(path, f"tubes{i}")
        imsave(base + ".tif", img.astype(np.float32))
        imsave(base + ".background.tif",
               (ndimage.distance_transform_edt(labels == 0) > SPARSE_BG_DIST).astype(np.uint8))
        save_skeletons(base + ".skeletons.npz", skels)
    return path


def run_tools(results: list, sparse_ckpt: str, sparse_vols, campaign_dir: str) -> None:
    """The JAX repo's last four user tools, ported under
    ``skoots_tpu_torch/tools/``, on the card:

    * ``skeleton_quality`` (host only): every method on every shape, the
      rows printed;
    * ``calibrate_sparse_ckpt`` on a copy of the sparse training phase's
      checkpoint and its volumes written as a training directory: launches
      exact (each calibrator forward the bench model's kernels), the
      parameters, optimizer state and other ``extra`` keys as they were,
      the threshold printed beside the one the save-time calibration wrote;
    * ``score_checkpoint`` on the campaign's separated checkpoint and
      validation volume: launches exact, F1 at IoU 0.5 >= 0.8 and mean IoU
      >= 0.7, printed beside the campaign's own score;
    * ``convergence`` at ``TOOLS_CONVERGENCE`` (epochs, steps): the tool's
      whole path -- phantoms, cfg, ``skoots-train-torch``, ``run_inference``,
      the score -- with every training and inference launch counted exactly
      and the stems' routes asserted; its score is not held to the bars at
      that size."""
    from skoots_tpu_torch.checkpoint import load_checkpoint
    from skoots_tpu_torch.config import load_cfg_from_file
    from skoots_tpu_torch.infer import engine
    from skoots_tpu_torch.kernels.bake import bake_skeleton_kernel
    from skoots_tpu_torch.kernels.dwconv import dwconv3d_wgrad
    from skoots_tpu_torch.tools import calibrate_sparse_ckpt, convergence
    from skoots_tpu_torch.tools import score_checkpoint, skeleton_quality

    t_phase = time.time()
    work = os.path.join(ROOT, "build", "tools_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    t0 = time.time()
    sq_out = os.path.join(work, "skeleton_quality_torch.json")
    _need(skeleton_quality.main(["--out", sq_out]) == 0, "skeleton_quality failed")
    with open(sq_out) as f:
        rows = json.load(f)
    print(f"tools [skeleton_quality]: {time.time() - t0:.1f} s (host), rows "
          f"{json.dumps(rows)}", flush=True)
    _need(sorted(rows) == sorted(skeleton_quality.SHAPES) and all(
        sorted(by_m) == sorted(skeleton_quality.METHODS) and all(
            0 < r["coverage"] <= 1 and 0 < r["inside"] <= 1 and r["n_points"] > 0
            for r in by_m.values()) for by_m in rows.values()),
        f"skeleton_quality rows {rows}")

    ckpt = os.path.join(work, "sparse.skoots")
    shutil.copy(sparse_ckpt, ckpt)
    train_dir = _tools_sparse_dir(os.path.join(work, "sparse_train"), sparse_vols)
    thr, counts, wall = _drive("tools [calibrate_sparse_ckpt]", lambda:
                               calibrate_sparse_ckpt.calibrate_checkpoint(ckpt, train_dir,
                                                                          "cuda"), results)
    before, after = load_checkpoint(sparse_ckpt), load_checkpoint(ckpt)
    saved = before["extra"]["calibrated_prob_threshold"]
    n = counts["ln_head"]
    print(f"tools [calibrate_sparse_ckpt]: threshold {thr!r}, the save-time calibration's "
          f"{saved!r} ({'equal' if thr == saved else f'differs by {thr - saved:.3g}'}), "
          f"{n} forwards", flush=True)
    _need(thr is not None and 1 <= n <= 8, f"calibrate_sparse_ckpt: {thr}, {n} forwards")
    for name, c in counts.items():
        _need(c == n * FORWARD_KERNELS_PER_TILE.get(name, 0),
              f"calibrate_sparse_ckpt: {name} {c} launches, {n} forwards")
    _need(after["extra"].pop("calibrated_prob_threshold") == thr
          and after["extra"] == {k: v for k, v in before["extra"].items()
                                 if k != "calibrated_prob_threshold"},
          f"calibrate_sparse_ckpt rewrote extra {after['extra']}")
    flat = [(_flat_leaves(before[k]), _flat_leaves(after[k])) for k in ("params", "opt_state")]
    _need(all(a.keys() == b.keys() and all(np.array_equal(a[q], b[q]) for q in a)
              for a, b in flat), "calibrate_sparse_ckpt changed the parameters or opt_state")
    _need((after["dataset_mean"], after["dataset_std"]) ==
          (before["dataset_mean"], before["dataset_std"]), "the dataset statistics changed")

    kernels = {**_launch_counters(), "dwconv3d_wgrad": dwconv3d_wgrad,
               "bake_skeleton": bake_skeleton_kernel}
    separated = os.path.join(campaign_dir, "separated")
    with open(os.path.join(separated, "result.json")) as f:
        campaign = json.load(f)
    with _stem_routes("tools [score_checkpoint]", {"forward": CAMPAIGN_STEM_ROUTES["forward"]}):
        rc, counts, wall = _drive("tools [score_checkpoint]", lambda: score_checkpoint.main(
            ["--outdir", separated, "--device", "cuda"]), results, kernels)
    with open(os.path.join(separated, "result.json")) as f:
        scored = json.load(f)
    want = _campaign_model_launches(0, 0, False, 0, engine.last_stats)
    print(f"tools [score_checkpoint]: F1@0.5 {scored['f1_at_iou50']} mean IoU "
          f"{scored['mean_iou']} (bars 0.8 / 0.7; the campaign scored "
          f"{campaign['f1_at_iou50']} / {campaign['mean_iou']}), engine {scored['engine']}, "
          f"{wall:.1f} s; launches expected {json.dumps(want)}", flush=True)
    _need(rc == 0 and scored["ok"], f"score_checkpoint: {scored}")
    for name, c in counts.items():
        _need(c == want[name], f"score_checkpoint: {name} {c} launches, expected {want[name]}")

    epochs, steps_per_epoch = TOOLS_CONVERGENCE
    outdir = os.path.join(work, "convergence")
    with _stem_routes("tools [convergence]", CAMPAIGN_STEM_ROUTES):
        rc, counts, wall = _drive("tools [convergence]", lambda: convergence.main(
            ["--epochs", str(epochs), "--steps-per-epoch", str(steps_per_epoch),
             "--outdir", outdir, "--device", "cuda"]), results, kernels)
    with open(os.path.join(outdir, "result.json")) as f:
        result = json.load(f)
    bsz = load_cfg_from_file(os.path.join(outdir, "cfg.yaml"))["TRAIN"]["TRAIN_BATCH_SIZE"]
    want = _campaign_model_launches(result["steps"], epochs, _tensorboard_panels(), bsz,
                                    engine.last_stats)
    print(f"tools [convergence] {epochs} x {steps_per_epoch}: rc {rc}, "
          f"{json.dumps(result)}; launches expected {json.dumps(want)}", flush=True)
    _need(rc == (0 if result["ok"] else 1) and result["steps"] == epochs * steps_per_epoch
          and result["engine"] and result["gt_instances"] >= 1, f"convergence: {result}")
    for name, c in counts.items():
        _need(c > 0, f"convergence: kernel {name} was not launched")
        _need(c == want[name], f"convergence: {name} {c} launches, expected {want[name]}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"tools phase: {time.time() - t_phase:.1f} s", flush=True)


def _flat_leaves(tree, prefix: str = "") -> dict:
    """``{path: array}`` of a loaded checkpoint tree (None: no leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_leaves(sub, f"{prefix}/{key}").items()}
    return {} if tree is None else {prefix: np.asarray(tree)}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port once on one GPU.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (with the phases they need), of: "
                         + ", ".join(name for name, _, _ in PHASES if name)
                         + "; default every phase")
    args = ap.parse_args(argv)
    phases = _phases_to_run(args.phases.split(",") if args.phases else None)

    print(gpu_line(), flush=True)
    _need(torch.cuda.is_available(), "no CUDA device: chip_smoke needs a GPU")
    block_pillow()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    import skoots_tpu_torch
    from skoots_tpu_torch.kernels import _build

    _need(os.path.dirname(os.path.dirname(os.path.abspath(
        skoots_tpu_torch.__file__))) == ROOT,
        f"skoots_tpu_torch must come from this checkout, not "
        f"{skoots_tpu_torch.__file__}")

    t0 = time.time()
    _build.library()
    print(f"build: {time.time() - t0:.1f} s -> {_build.library_path()}", flush=True)
    print(f"tensor-core instructions (cuobjdump -sass): "
          f"{json.dumps(tensor_core_sass(_build.library_path()))}", flush=True)

    check_yaml_reader()
    with _stem_routes("the whole run"):
        results = run_all(phases)
    for r in results:
        r.pop("_largest")
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _release_slice(s: dict) -> None:
    """Free the 512^3 phantom's model, volume and pipelines before the
    thrifty engine."""
    import torch

    for key in ("ckpt", "model", "volume", "chunked", "chunked_peak", "chunked_run"):
        s.pop(key, None)
    torch.cuda.empty_cache()


def _release_u8(s: dict) -> None:
    import torch

    s.pop("vol_u8", None)
    torch.cuda.empty_cache()


def _phase_kernels(s: dict) -> None:
    s["results"] = check_kernels()
    check_microbenchmarks(s["results"])
    check_train_kernels(s["results"])


def _phase_host(s: dict) -> None:
    (s["host_phantom"], s["n_default"], s["n_expected"], s["host_mask"],
     s["block_origin"]) = run_host_engine(s["results"])


def _phase_slice(s: dict) -> None:
    import torch

    (s["ckpt"], s["model"], s["volume"], s["chunked"], s["chunked_peak"],
     s["chunked_run"]) = run_slice(s["results"])
    check_against_cpu(s["ckpt"], s["model"], s["volume"])
    torch.cuda.empty_cache()


def _phase_thrifty(s: dict) -> None:
    s["vol_u8"], s["tile_bytes"] = run_thrifty(
        s["results"], s["ckpt"], s["model"], s["volume"], s["chunked"], s["chunked_peak"],
        s["chunked_run"])


def _phase_sparse_train(s: dict) -> None:
    s["sparse_vols"] = run_skeletonize([(r.image, r.masks) for r in s["records"]])
    s["sparse_ckpt"] = run_sparse_train(s["results"], s["sparse_vols"])


# (name, the phases it needs, what it runs on the state ``s``), in the
# order of a whole run; a nameless entry frees memory and always runs
PHASES = (
    ("kernels", (), _phase_kernels),
    ("host", (), _phase_host),
    ("device_pipeline", ("host",), lambda s: run_device_pipeline(
        s["results"], s["host_phantom"], s["n_expected"], s["block_origin"])),
    ("tif", ("host",), lambda s: run_tif(s["results"], s["host_phantom"], s["host_mask"])),
    ("experimental", ("host",), lambda s: run_experimental(
        s["results"], s["host_phantom"], s["n_default"], s["n_expected"])),
    ("slice", (), _phase_slice),
    ("wide", ("slice",), lambda s: run_wide(s["results"], s["volume"], s["model"],
                                            s["chunked_run"])),
    ("kernel_sizes", ("slice",), lambda s: run_kernel_sizes(s["results"], s["volume"],
                                                            s["chunked_run"])),
    ("thrifty", ("slice",), _phase_thrifty),
    ("sparse_probe", ("slice",), lambda s: check_sparse_probe(
        s["results"], s["ckpt"], s["model"], s["volume"])),
    ("cc_variants", ("slice", "thrifty"), lambda s: run_cc_variants(
        s["results"], s["ckpt"], s["model"], s["volume"], s["chunked"], s["chunked_run"],
        s["vol_u8"])),
    ("", (), _release_slice),
    ("thrifty_engine", ("thrifty",), lambda s: run_thrifty_engine(
        s["results"], s["vol_u8"], s["tile_bytes"])),
    ("", (), _release_u8),
    ("scale", (), lambda s: run_scale(s["results"])),
    ("sharded", (), lambda s: run_sharded(s["results"])),
    ("grads", (), lambda s: check_grads_against_cpu()),
    ("train", (), lambda s: s.update(records=run_train_slice(s["results"]))),
    ("train_variants", ("train",), lambda s: s.update(
        unet_ckpt=run_train_variants(s["results"], s["records"]))),
    ("resume", ("train",), lambda s: run_resume(s["records"])),
    ("dp_train", ("train",), lambda s: run_dp_train(s["results"], s["records"])),
    ("unet_inference", ("train_variants",), lambda s: run_unet_inference(
        s["results"], s["unet_ckpt"])),
    ("sparse_train", ("train",), _phase_sparse_train),
    ("sparse_inference", ("sparse_train", "host"), lambda s: run_sparse_inference(
        s["results"], s["sparse_ckpt"], s["host_phantom"])),
    ("perslice", ("host",), lambda s: run_perslice_slice(
        s["results"], s["host_phantom"], s["n_default"])),
    ("campaign", (), lambda s: s.update(campaign_dir=run_campaign(s["results"]))),
    ("tools", ("sparse_train", "campaign"), lambda s: run_tools(
        s["results"], s["sparse_ckpt"], s["sparse_vols"], s["campaign_dir"])),
)


def _phases_to_run(names=None) -> set:
    """The named phases and every phase they need (None: all of them)."""
    needs = {name: deps for name, deps, _ in PHASES if name}
    if names is None:
        return set(needs)
    unknown = sorted(set(names) - set(needs))
    _need(not unknown, f"unknown phases {unknown}; known: {', '.join(needs)}")
    todo, stack = set(), list(names)
    while stack:
        name = stack.pop()
        if name not in todo:
            todo.add(name)
            stack.extend(needs[name])
    return todo


def run_all(phases=None) -> list:
    """The phases after the build, in order (``phases``: the set of
    :func:`_phases_to_run`, default every phase); returns the kernels'
    results."""
    phases = _phases_to_run() if phases is None else phases
    s = {"results": []}
    for name, _, fn in PHASES:
        if not name or name in phases:
            fn(s)
    for done in ("sparse_smoke", "campaign_smoke"):  # what run_tools read
        shutil.rmtree(os.path.join(ROOT, "build", done), ignore_errors=True)
    return s["results"]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
