"""The port's own spans and counters, on the profiler's host clock.

A span is a named interval of host time: its name, start and end in ns of
``time.time_ns()`` (the clock ``torch.profiler`` stamps its host events
with, so spans share the device trace's timeline), the index of its parent
(the innermost span open on its thread when it opened, or -1), its thread
(the native id, as the profiler's tracks name threads) and a unit id. A
root span (``root=True``) is one unit of work, a block or a step: the spans
inside it carry its id, and so do spans opened outside any root before it
opens (a step's data wait and augmentation, which come before the step), so
a root's closing starts the next unit. A count is one event of a counter,
kept by name and site with its time, its enclosing span and unit:
``host_sync`` counts the points where the host waits for the card.

Recording is on only while a ``torch.profiler`` profile records the calling
thread (``torch._C._autograd._profiler_enabled()``, a tenth of a µs, then
the profiler's kind: ``emit_nvtx`` and ``emit_itt`` turn the same switch on
but keep no events, so nothing records under them) or inside
:func:`recording`. Off, :func:`span` returns one shared no-op object
and :func:`count` returns at once. Nothing is handed to the profiler: a
``record_function`` range costs ≈ 14 µs and shows on the device trace as a
``gpu_user_annotation`` event spanning the kernels issued inside it. What
is recorded stays in memory until :func:`reset`; :func:`totals` sums it for
readers and :func:`export_chrome` writes it for Perfetto.

Spans and counters of the program:

* ``seg.block`` (root), ``seg.forward`` / ``seg.cc`` / ``seg.assign`` (the
  phases of ``run.last_phase_s``), ``seg.tile`` (a forward tile),
  ``seg.release_cache``, ``seg.mask_d2h`` (the wait for the instance mask's
  last slab to land in pinned host memory): the device pipelines
  (``infer/device_pipeline.py``);
* ``sharded.fwd`` / ``.cc`` / ``.assign`` and ``perslice.assign`` /
  ``.stitch``: the phases of the sharded run and the per-slice mode;
* ``train.step`` (root) with ``train.forward``, ``train.backward`` and
  ``train.optimizer`` (``train/engine.py::make_train_step``),
  ``train.data_wait`` (``train/data.py::prefetch_iterator``'s consumer),
  ``train.augment`` (``train/transforms.py::make_batch_augment``);
* ``host_sync``, by site, on the device pipelines' and the training step's
  paths: a synchronise, a host read of a card's value (a CC poll), a
  ``nonzero`` or boolean index, a copy from the host to the card, an
  ``empty_cache``. Counted only where a card is involved (no count on the
  CPU). Sites end in what waits: ``.synchronize`` and ``.empty_cache``
  wait for the whole card, the rest for the stream;
* ``mask_d2h``, by site: each slab copy of the device pipelines' instance
  mask to the host, ``overlapped`` while assign tiles remain to be issued,
  else ``tail``. Counted only on a card.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from contextlib import contextmanager

import torch

_enabled = torch._C._autograd._profiler_enabled
_kind = torch._C._autograd._profiler_type
_KINETO = torch._C._profiler.ActiveProfilerType.KINETO


def _profiling() -> bool:
    """A ``torch.profiler`` profile records this thread."""
    return _enabled() and _kind() == _KINETO


class _Off:
    """The span of a tracer that is not recording: enters and exits."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "root", "rec")

    def __init__(self, tracer, name, root):
        self.tracer, self.name, self.root = tracer, name, root

    def __enter__(self):
        self.rec = self.tracer._open(self.name, self.root)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self.rec, self.root)
        return False


class Tracer:
    """Spans and counts of one process (the module's functions use one
    instance, :data:`TRACER`). Records are lists: a span ``[name, start ns,
    end ns or None while open, parent index, thread, unit]``, a count
    ``(name, site, ns, parent index, thread, unit)``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._forced = 0
        self.spans: list = []
        self.counts: list = []
        self.unit = 0  # the id of the next root span

    def span(self, name: str, root: bool = False):
        """A context manager recording the span ``name`` while recording is
        on, else the shared no-op."""
        if not (self._forced or _profiling()):
            return _OFF
        return _Span(self, name, root)

    def count(self, name: str, site: str) -> None:
        """One event of counter ``name`` at ``site`` while recording is on."""
        if not (self._forced or _profiling()):
            return
        local = self._thread()
        with self._lock:
            parent = local.stack[-1] if local.stack else -1
            unit = self.spans[parent][5] if parent >= 0 else self.unit
            self.counts.append((name, site, time.time_ns(), parent, local.tid, unit))

    def host_sync(self, site: str, device) -> None:
        """Count a ``host_sync`` at ``site`` when ``device``, where the value
        the host waits for lives or goes, is a card."""
        if (self._forced or _profiling()) and torch.device(device).type == "cuda":
            self.count("host_sync", site)

    @contextmanager
    def recording(self):
        """Record inside the block whether a profiler runs or not, on every
        thread."""
        with self._lock:
            self._forced += 1
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1

    def reset(self) -> None:
        """Drop every record (call it with no span open)."""
        with self._lock:
            self.spans, self.counts, self.unit = [], [], 0
        self._local = threading.local()

    def _thread(self):
        """This thread's stack of open spans and its native id (read once:
        it is a system call)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
        return local

    def _open(self, name, root):
        local = self._thread()
        with self._lock:
            parent = local.stack[-1] if local.stack else -1
            unit = self.spans[parent][5] if parent >= 0 and not root else self.unit
            rec = [name, time.time_ns(), None, parent, local.tid, unit]
            self.spans.append(rec)
            local.stack.append(len(self.spans) - 1)
        return rec

    def _close(self, rec, root):
        rec[2] = time.time_ns()
        stack = self._thread().stack
        if stack:
            stack.pop()
        if root:
            with self._lock:
                self.unit = max(self.unit, rec[5] + 1)

    def totals(self) -> dict:
        """``{"spans": {name: {"n", "s", "self_s"}}, "counters": {name:
        {site: n}}}`` over the closed spans and every count: a span name's
        count, seconds, and seconds less those of its closed children."""
        with self._lock:
            spans, counts = list(self.spans), list(self.counts)
        child_ns = [0] * len(spans)
        for name, start, end, parent, _, _ in spans:
            if end is not None and parent >= 0:
                child_ns[parent] += end - start
        out: dict = {}
        for i, (name, start, end, _, _, _) in enumerate(spans):
            if end is None:
                continue
            t = out.setdefault(name, {"n": 0, "s": 0.0, "self_s": 0.0})
            t["n"] += 1
            t["s"] += (end - start) * 1e-9
            t["self_s"] += (end - start - child_ns[i]) * 1e-9
        counters: dict = {}
        for name, site, *_ in counts:
            by_site = counters.setdefault(name, {})
            by_site[site] = by_site.get(site, 0) + 1
        return {"spans": out, "counters": counters}

    def export_chrome(self, path: str, since_ns: int = 0) -> None:
        """Add the closed spans that start at or after ``since_ns`` (complete
        events) and the counts since then (instant events) to the Chrome
        trace at ``path``, on its timeline (a ``torch.profiler`` export's
        ``baseTimeNanoseconds``) and on this process's threads, so Perfetto
        shows them over its events; or write a trace of their own where
        there is no file."""
        trace = {"traceEvents": []}
        if os.path.exists(path):
            with open(path) as f:
                trace = json.load(f)
        base = int(trace.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        with self._lock:
            spans, counts = list(self.spans), list(self.counts)
        trace["traceEvents"] += [
            {"ph": "X", "cat": "skoots", "name": name, "pid": pid, "tid": tid,
             "ts": (start - base) / 1e3, "dur": (end - start) / 1e3, "args": {"unit": unit}}
            for name, start, end, _, tid, unit in spans if end is not None and start >= since_ns]
        trace["traceEvents"] += [
            {"ph": "i", "s": "t", "cat": "skoots", "name": name, "pid": pid, "tid": tid,
             "ts": (t - base) / 1e3, "args": {"site": site, "unit": unit}}
            for name, site, t, _, tid, unit in counts if t >= since_ns]
        with open(path, "w") as f:
            json.dump(trace, f)


class PhaseClock:
    """Host seconds of a run's phases, between synchronisations:
    ``owner.last_phase_s`` is emptied at the start, where ``sync`` (if
    any) runs first; ``with clock(tag):`` runs ``sync`` at the phase's end
    and stores the seconds since the previous phase's end (or the start),
    rounded to ms, under ``tag``. While recording, each phase is also the
    span ``<prefix>.<name>``, ``name`` the tag without a leading ``N-``."""

    def __init__(self, owner, prefix: str, sync=None):
        self.owner, self.prefix, self.sync = owner, prefix, sync
        owner.last_phase_s = {}
        if sync is not None:
            sync()
        self.t0 = time.time_ns()

    @contextmanager
    def __call__(self, tag: str):
        with span(f"{self.prefix}.{tag.split('-', 1)[-1]}"):
            yield
            if self.sync is not None:
                self.sync()
        t1 = time.time_ns()
        self.owner.last_phase_s[tag] = round((t1 - self.t0) * 1e-9, 3)
        self.t0 = t1


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
recording = TRACER.recording
reset = TRACER.reset
host_sync = TRACER.host_sync
totals = TRACER.totals
export_chrome = TRACER.export_chrome


def spanned(name: str, root: bool = False):
    """Decorate a function so that each call is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, root):
                return fn(*args, **kwargs)

        return call

    return wrap


def to_device(tensor: torch.Tensor, device, site: str) -> torch.Tensor:
    """``tensor.to(device)``; a copy from the host to a card, which waits
    for the card (from pageable memory it drains the stream first), counted
    as a ``host_sync`` at ``site``."""
    if tensor.device.type == "cpu":
        host_sync(site, device)
    return tensor.to(device)


def synchronize(device, site: str) -> None:
    """``torch.cuda.synchronize(device)`` on a card, counted as a
    ``host_sync`` at ``site``; nothing on another device."""
    device = torch.device(device)
    if device.type == "cuda":
        host_sync(site, device)
        torch.cuda.synchronize(device)
