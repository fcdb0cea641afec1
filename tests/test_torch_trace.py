"""The port's spans and counters (``skoots_tpu_torch/utils/trace.py``): off
means nothing is recorded; nesting, parents, threads and unit ids; the
shared clock with ``torch.profiler`` and nothing handed to it; the spans of
the device pipelines and of a train step; the Chrome export and
``train()``'s profile. Imports no JAX, so the ``cuda`` cases run on a
card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -m cuda

There they check the spans against the kernels' CUPTI intervals and the
``host_sync`` counts against ``torch.cuda.set_sync_debug_mode("warn")``.
"""

import collections
import json
import threading
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from skoots_tpu_torch.config import get_cfg_defaults, merge_from_dict
from skoots_tpu_torch.infer import device_pipeline as dp
from skoots_tpu_torch.utils import trace
from skoots_tpu_torch.utils.synthetic import make_tubes

SEG = {"seg.block", "seg.forward", "seg.cc", "seg.assign", "seg.tile"}
TRAIN = {"train.step", "train.forward", "train.backward", "train.optimizer",
         "train.data_wait", "train.augment"}
TINY_MODEL = {"DIMS": [4, 8, 16, 8, 4], "DEPTHS": [1, 1, 1, 1, 1], "OUT_CHANNELS": 4,
              "KERNEL_SIZE": 3, "DTYPE": "float32"}


@pytest.fixture(autouse=True)
def fresh():
    """The process's tracer emptied before and after each test; one torch
    thread, as the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield trace.TRACER
    trace.reset()
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _by_name(tracer):
    out = {}
    for i, rec in enumerate(tracer.spans):
        out.setdefault(rec[0], []).append((i, rec))
    return out


def test_off_records_nothing_and_returns_one_shared_noop(fresh):
    assert not torch._C._autograd._profiler_enabled()
    a, b = trace.span("x"), trace.span("y", root=True)
    assert a is b
    with a:
        trace.count("host_sync", "here")
        trace.host_sync("here", "cuda")
    with trace.PhaseClock(type("Run", (), {})(), "p")("1-a"):
        pass
    assert fresh.spans == [] and fresh.counts == [] and fresh.unit == 0
    assert trace.totals() == {"spans": {}, "counters": {}}
    with trace.recording():
        assert trace.span("x") is not trace.span("x")


def test_nvtx_and_itt_modes_record_nothing(fresh):
    """``emit_itt`` (like ``emit_nvtx`` on a card) turns the autograd
    profiler on in a mode that keeps no events: the spans stay off there."""
    with torch.autograd.profiler.emit_itt():
        assert torch._C._autograd._profiler_enabled()
        assert trace.span("x") is trace.span("y", root=True)
        with trace.span("x"):
            trace.count("host_sync", "here")
    assert fresh.spans == [] and fresh.counts == []


def test_nesting_parents_threads_and_units(fresh):
    """Three steps, each a data wait on the prefetch queue, an augmentation
    and a root step with a child; the producer thread opens spans of its
    own. A step's wait and augmentation carry its unit; the producer's
    spans are parented on its own thread only."""
    produced = []

    def epoch_iter(epoch):
        for i in range(3):
            with trace.span("make"):
                with trace.span("make.inner"):
                    trace.count("host_sync", "make")
            produced.append(threading.get_native_id())
            yield i

    from skoots_tpu_torch.train.data import prefetch_iterator

    with trace.recording():
        for _ in prefetch_iterator(epoch_iter)(0):
            with trace.span("train.augment"):
                trace.count("host_sync", "aug")
            with trace.span("train.step", root=True):
                with trace.span("train.forward"):
                    trace.count("host_sync", "fwd")
    spans = _by_name(fresh)
    main = threading.get_native_id()
    assert len(spans["train.step"]) == 3 and len(spans["make"]) == 3
    # the consumer waits four times: three batches and the end
    assert len(spans["train.data_wait"]) == 4
    for u, (i, step) in enumerate(spans["train.step"]):
        assert step[3] == -1 and step[4] == main and step[5] == u
        fwd = spans["train.forward"][u][1]
        assert fwd[3] == i and fwd[5] == u and step[1] <= fwd[1] <= fwd[2] <= step[2]
        for name in ("train.data_wait", "train.augment"):
            rec = spans[name][u][1]
            assert rec[3] == -1 and rec[4] == main and rec[5] == u and rec[2] <= step[1]
    assert spans["train.data_wait"][3][1][5] == 3  # the next unit's
    for (i, make), (_, inner) in zip(spans["make"], spans["make.inner"]):
        assert make[4] == inner[4] == produced[0] != main
        assert make[3] == -1 and inner[3] == i
    sites = [(c[1], c[3], c[5]) for c in fresh.counts if c[4] == main]
    assert [s for s, *_ in sites] == ["aug", "fwd"] * 3
    assert all(unit == k // 2 for k, (_, _, unit) in enumerate(sites))
    tot = trace.totals()
    assert tot["counters"] == {"host_sync": {"make": 3, "aug": 3, "fwd": 3}}
    st = tot["spans"]["train.step"]
    assert st["n"] == 3 and 0 <= st["self_s"] <= st["s"]
    assert st["s"] - st["self_s"] == pytest.approx(tot["spans"]["train.forward"]["s"])


def test_spans_share_the_profilers_clock_and_stay_out_of_its_events(fresh):
    """Under a CPU profile the spans record, each span's interval holds the
    profiler's host events of the ops issued inside it, and no profiler
    event carries a span's name."""
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("probe") is not trace.span("probe")
        with trace.span("outer", root=True):
            with trace.span("inner"):
                y = x + 1
            z = y * 3
        del z
    names = {"aten::add": "inner", "aten::mul": "outer"}
    spans = {rec[0]: rec for rec in fresh.spans}
    assert set(spans) == {"outer", "inner"}
    seen = set()
    for e in prof.profiler.kineto_results.events():
        assert e.name() not in spans
        if e.name() in names:
            rec = spans[names[e.name()]]
            assert rec[1] <= e.start_ns() and e.start_ns() + e.duration_ns() <= rec[2]
            seen.add(e.name())
    assert seen == set(names)
    assert trace.span("probe") is trace.span("probe")


def test_phase_clock_keeps_the_phase_seconds_and_spans_each_phase(fresh):
    class Run:
        last_phase_s = {"old": 1.0}

    run, synced = Run(), []
    with trace.recording():
        phase = trace.PhaseClock(run, "seg", lambda: synced.append(1))
        assert run.last_phase_s == {} and len(synced) == 1
        for tag in ("1-forward", "2-cc", "3-assign"):
            with phase(tag):
                pass
    assert list(run.last_phase_s) == ["1-forward", "2-cc", "3-assign"]
    assert all(v == round(v, 3) and v >= 0 for v in run.last_phase_s.values())
    assert len(synced) == 4
    assert [rec[0] for rec in fresh.spans] == ["seg.forward", "seg.cc", "seg.assign"]
    assert all(a[2] <= b[1] for a, b in zip(fresh.spans, fresh.spans[1:]))


def _tile_model(tile):
    """A stand-in forward: five channels a voxel from the tile itself."""
    t = tile[0, ..., 0]
    fg = (t > t.mean()).float()
    vec = torch.zeros(t.shape + (3,))
    return torch.cat([vec, fg[..., None], fg[..., None]], -1)[None]


@pytest.mark.parametrize("factory", ["make_chunked_pipeline", "make_thrifty_pipeline",
                                     "make_device_pipeline"])
def test_pipelines_record_their_spans_on_the_cpu(fresh, factory):
    """A block of each device pipeline on the CPU, recorded: one
    ``seg.block`` over its three phases, a ``seg.tile`` a forward tile
    under ``seg.forward``, one unit; no release and no host sync off a
    card; ``last_phase_s`` keeps its keys, and a second, unrecorded block
    records nothing."""
    img, _, _ = make_tubes(shape=(32, 32, 16), n_tubes=2, radius=3, seed=5)
    run = getattr(dp, factory)(_tile_model, img.shape, crop=(16, 16, 16),
                               overlap=(0, 0, 0), device="cpu")
    with trace.recording():
        run(img, 0.0, 1.0)
    assert set(run.last_phase_s) == {"1-forward", "2-cc", "3-assign"}
    tot = trace.totals()
    assert set(tot["spans"]) == SEG and tot["counters"] == {}
    assert tot["spans"]["seg.tile"]["n"] == run.tile_plan["forward"] == 4
    spans = _by_name(fresh)
    (root, block), = spans["seg.block"]
    assert {rec[5] for rec in fresh.spans} == {0} and fresh.unit == 1
    for name in ("seg.forward", "seg.cc", "seg.assign"):
        assert [rec[3] for _, rec in spans[name]] == [root]
    fwd = spans["seg.forward"][0][0]
    assert all(rec[3] == fwd for _, rec in spans["seg.tile"])
    n = len(fresh.spans)
    run(img, 0.0, 1.0)
    assert len(fresh.spans) == n


def _train_parts(device, steps=2):
    """The benchmark's dense training loop at a tiny size: in-memory tube
    records, the prefetched host batches, the batch augmentation and the
    step."""
    from skoots_tpu_torch.models import init_model
    from skoots_tpu_torch.train.data import (
        MultiDataset,
        SkootsDataset,
        VolumeRecord,
        batch_iterator,
        prefetch_iterator,
    )
    from skoots_tpu_torch.train.engine import cfg_optimizer, make_train_step
    from skoots_tpu_torch.train.sigma import init_sigma
    from skoots_tpu_torch.train.transforms import make_batch_augment

    cfg = merge_from_dict(get_cfg_defaults(), {
        "MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
        "TRAIN": {"MAX_SKELETON_POINTS": 64, "LOSS_SKELETON_START_EPOCH": -1},
        "AUGMENTATION": {"CROP_WIDTH": 32, "CROP_HEIGHT": 32, "CROP_DEPTH": 8}})
    records = []
    for seed in range(2):
        img, lab, sk = make_tubes(shape=(64, 64, 8), n_tubes=2, radius=3, seed=seed)
        records.append(VolumeRecord(img.astype(np.float32), lab, sk))
    data = MultiDataset([SkootsDataset(records, cfg)])
    mean, std = data.mean_std()
    batches = prefetch_iterator(batch_iterator(data, 1, steps, 7))(0)
    augment = make_batch_augment(cfg, mean, std, data.intensity_ceiling(), device=device)
    model = init_model(cfg, 0, device=device).train()
    opt, sched = cfg_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, sched, init_sigma(cfg), cfg)
    gen = torch.Generator().manual_seed(3)
    return batches, augment, step, gen


def test_train_step_records_its_spans_on_the_cpu(fresh):
    batches, augment, step, gen = _train_parts("cpu")
    with trace.recording():
        for host in batches:
            step(augment(host, gen), 1)
    tot = trace.totals()
    assert set(tot["spans"]) == TRAIN and tot["counters"] == {}
    assert {k: v["n"] for k, v in tot["spans"].items()} == {
        **{k: 2 for k in TRAIN}, "train.data_wait": 3}
    spans = _by_name(fresh)
    for u, (i, rec) in enumerate(spans["train.step"]):
        assert rec[5] == u and rec[3] == -1
        for name in ("train.forward", "train.backward", "train.optimizer"):
            child = spans[name][u][1]
            assert child[3] == i and child[5] == u
        assert spans["train.augment"][u][1][5] == spans["train.data_wait"][u][1][5] == u


def test_chrome_export_puts_the_spans_on_the_profilers_timeline(fresh, tmp_path):
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer", root=True):
            trace.count("host_sync", "site")
            y = x + 1
    del y
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    trace.export_chrome(path)
    ev = json.load(open(path))["traceEvents"]
    span, = [e for e in ev if e.get("cat") == "skoots" and e["ph"] == "X"]
    count, = [e for e in ev if e.get("cat") == "skoots" and e["ph"] == "i"]
    add, = [e for e in ev if e["name"] == "aten::add" and e["ph"] == "X"]
    assert span["name"] == "outer" and count["args"]["site"] == "site"
    assert (span["pid"], span["tid"]) == (add["pid"], add["tid"])
    assert span["ts"] <= add["ts"] and add["ts"] + add["dur"] <= span["ts"] + span["dur"]
    # no file: a trace of their own, in µs of the clock
    own = str(tmp_path / "own.json")
    trace.export_chrome(own, since_ns=fresh.spans[0][1] + 1)
    assert [e["ph"] for e in json.load(open(own))["traceEvents"]] == ["i"]


def test_train_profile_writes_the_spans_into_its_trace(fresh, tmp_path):
    """``TRAIN.AUTOGRAD_PROFILE`` on the CPU: the profiler's trace holds the
    steps' spans beside the ops."""
    from skoots_tpu_torch.train.engine import train

    batches, augment, _, gen = _train_parts("cpu")
    dev_batches = [augment(h, gen) for h in batches]
    cfg = merge_from_dict(get_cfg_defaults(), {
        "MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
        "TRAIN": {"NUM_EPOCHS": 1, "SAVE_PATH": str(tmp_path), "AUTOGRAD_PROFILE": True,
                  "LOSS_SKELETON_START_EPOCH": -1}})
    train(cfg, lambda e: iter(dev_batches), "cpu")
    ev = json.load(open(tmp_path / "torch_trace" / "trace.json"))["traceEvents"]
    ours = [e["name"] for e in ev if e.get("cat") == "skoots"]
    assert ours.count("train.step") == 2 and "train.backward" in ours
    assert any(e["name"].startswith("aten::") for e in ev)
    assert fresh.spans == [] and fresh.counts == []  # written out, then dropped


def test_train_refuses_two_profilers_before_entering_either(fresh, tmp_path):
    from skoots_tpu_torch.train.engine import train

    cfg = merge_from_dict(get_cfg_defaults(), {
        "MODEL": TINY_MODEL, "TRAIN": {"SAVE_PATH": str(tmp_path), "AUTOGRAD_PROFILE": True,
                                       "AUTOGRAD_EMIT_NVTX": True,
                                       "AUTOGRAD_DETECT_ANOMALY": True}})
    with pytest.raises(ValueError, match="AUTOGRAD_EMIT_NVTX"):
        train(cfg, lambda e: iter(()), "cpu")
    assert not torch._C._autograd._profiler_enabled()
    assert not torch.is_anomaly_enabled()


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_spans_hold_the_kernels_they_wait_for_on_the_card(fresh, card):
    """A GEMM issued and synchronised inside a span: its CUPTI interval in
    the same profile lies inside the span's interval (the card's trace and
    the spans share a clock)."""
    x = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("gemm", root=True):
            y = x @ x
            torch.cuda.synchronize(card)
    del y
    rec, = fresh.spans
    kernels = [e for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA") and "gemm" in e.name().lower()]
    assert kernels
    for e in kernels:
        assert rec[1] <= e.start_ns() and e.start_ns() + e.duration_ns() <= rec[2], (
            rec[1], e.start_ns(), e.duration_ns(), rec[2])


@pytest.mark.cuda
def test_train_emit_nvtx_records_no_spans_on_the_card(fresh, card, tmp_path):
    """``TRAIN.AUTOGRAD_EMIT_NVTX`` on the card: the steps run under
    ``emit_nvtx`` and the tracer keeps nothing of them."""
    from skoots_tpu_torch.train.engine import train

    batches, augment, _, gen = _train_parts(card)
    dev_batches = [augment(h, gen) for h in batches]
    cfg = merge_from_dict(get_cfg_defaults(), {
        "MODEL": TINY_MODEL, "SKOOTS": {"VECTOR_SCALING": [8, 8, 4]},
        "TRAIN": {"NUM_EPOCHS": 1, "SAVE_PATH": str(tmp_path), "AUTOGRAD_EMIT_NVTX": True,
                  "LOSS_SKELETON_START_EPOCH": -1}})
    state = train(cfg, lambda e: iter(dev_batches), card)
    assert state.step == 2
    assert not torch._C._autograd._profiler_enabled()
    assert fresh.spans == [] and fresh.counts == []


def _place():
    """(file, line) of the innermost frame of the port outside the tracer
    on the stack, or None."""
    port = [f for f in traceback.extract_stack()
            if "skoots_tpu_torch" in f.filename and not f.filename.endswith("trace.py")]
    return (port[-1].filename.rsplit("/", 1)[-1], port[-1].lineno) if port else None


def _syncs_by_place(fn, monkeypatch):
    """(fn's result, the sites of the ``host_sync`` counts made while it
    runs by the place that made each, the waits torch reports by the
    place that issued each, the stack of a wait outside the port by its
    place). The sync debug mode reports the waits for the stream; a
    whole-card ``synchronize`` or ``empty_cache`` is taken at its call, with
    the mode off inside it (torch 2.11 reports neither)."""
    counted = collections.defaultdict(list)
    waits = collections.Counter()
    outside = {}
    real_count = trace.Tracer.count

    def count(self, name, site):
        n = len(self.counts)
        real_count(self, name, site)
        if len(self.counts) > n:
            counted[_place()].append(site)

    def whole_card(real):
        def call(*args, **kwargs):
            waits[_place() or ("?", 0)] += 1
            torch.cuda.set_sync_debug_mode(0)
            try:
                return real(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("warn")

        return call

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            place = _place()
            if place is None:
                place = (filename.rsplit("/", 1)[-1], lineno)
                outside[place] = "".join(traceback.format_stack()[-12:])
            waits[place] += 1

    torch.cuda.synchronize()
    with monkeypatch.context() as m, warnings.catch_warnings():
        m.setattr(trace.Tracer, "count", count)
        m.setattr(trace, "count", trace.TRACER.count)
        m.setattr(torch.cuda, "synchronize", whole_card(torch.cuda.synchronize))
        m.setattr(torch.cuda, "empty_cache", whole_card(torch.cuda.empty_cache))
        # the first switch to "warn" in a process reports a wait of its own
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.simplefilter("always")
        warnings.showwarning = show
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, counted, waits, outside


def _assert_site_by_site(counted, waits, outside, counters):
    """Each wait is put down to the counted place on its line or up to
    three lines above it in its file (a count stands just before the
    operation that waits); every counted place has as many waits as counts,
    and no wait is left over. The totals agree too."""
    per = {p: [len(sites), 0, sites[0]] for p, sites in counted.items()}
    stray = {}
    for (f, line), n in waits.items():
        near = [p for p in per if p is not None and p[0] == f and line - 3 <= p[1] <= line]
        if near:
            per[max(near, key=lambda p: p[1])][1] += n
        else:
            stray[(f, line)] = n
    wrong = {p: v for p, v in per.items() if v[0] != v[1]}
    assert not wrong and not stray, (wrong, stray, outside)
    assert sum(counters.get("host_sync", {}).values()) == sum(waits.values())


@pytest.mark.cuda
def test_host_syncs_match_the_sync_debug_mode_over_a_block(fresh, card, monkeypatch):
    """One block of the chunked pipeline with a tiny UNeXT on the card,
    recorded: every wait torch reports is a counted site, site by site;
    four phase-clock synchronises and three releases a block."""
    from skoots_tpu_torch.models import init_model

    cfg = merge_from_dict(get_cfg_defaults(), {"MODEL": TINY_MODEL})
    model = init_model(cfg, 0, device=card).eval()
    img, _, _ = make_tubes(shape=(64, 64, 32), n_tubes=3, radius=3, seed=2)
    run = dp.make_chunked_pipeline(model, img.shape, crop=(32, 32, 32), overlap=(0, 0, 0),
                                   prob_threshold=0.5, embed_compact_div=16, device=card)
    run(img, float(img.mean()), float(img.std()))  # warm
    trace.reset()
    with trace.recording():
        _, *found = _syncs_by_place(
            lambda: run(img, float(img.mean()), float(img.std())), monkeypatch)
    tot = trace.totals()
    assert tot["spans"]["seg.block"]["n"] == 1
    assert tot["spans"]["seg.release_cache"]["n"] == 3
    assert tot["counters"]["host_sync"]["phase_clock.synchronize"] == 4
    assert tot["counters"]["host_sync"]["release_cache.empty_cache"] == 3
    _assert_site_by_site(*found, tot["counters"])


@pytest.mark.cuda
def test_host_syncs_match_the_sync_debug_mode_over_train_steps(fresh, card, monkeypatch):
    """Four data waits, augmentations and steps of the dense loop on the
    card, recorded: every wait torch reports is a counted site, site by
    site."""
    batches, augment, step, gen = _train_parts(card, steps=5)
    step(augment(next(batches), gen), 1)  # warm

    def four():
        for host in batches:
            step(augment(host, gen), 1)

    trace.reset()
    with trace.recording():
        _, *found = _syncs_by_place(four, monkeypatch)
    tot = trace.totals()
    assert tot["spans"]["train.step"]["n"] == 4
    _assert_site_by_site(*found, tot["counters"])
