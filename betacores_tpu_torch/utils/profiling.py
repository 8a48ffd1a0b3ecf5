"""Timed sections and traces (counterpart of betacores_tpu/utils/profiling.py).

``Timings`` accumulates named wall-clock sections. A CUDA launch returns
before the card has run it, so a section ends by synchronising the devices
of the tensors registered with ``hold`` (or, with none registered, the
current card when CUDA is in use): its time is the work's, not the
enqueue's. ``save`` writes the reference's artifacts,
``<prefix>_<name>_time.npy`` per section and ``<prefix>_timings.json``.
``trace(logdir)`` runs a ``torch.profiler`` trace of the CPU and, with a
card, of the card, and writes it to ``logdir`` as a Chrome trace.

The program's spans and counters. ``annotate(name)`` is a span: a range in
the profiler's timeline, an NVTX range on the card, and a record of the
process-wide recorder. The recorder is on inside ``recording()`` (an
operator's switch) and whenever a torch profiler runs; off, a span or a
count reads two flags and makes no event, range or record (so an NVTX-only
tool sees the spans inside ``recording()`` alone). The recorder keeps one
aggregate per span name, parent span name and whether the span runs in a
captured graph: its calls, the host start and end (``time.time_ns()``, the
clock the profiler stamps its events on) of the last call, and, with CUDA
in use, the device start and end of the last call from CUDA events at its
edges, put on the host's clock by one
anchor event recorded beside a synchronisation at the first span after
``reset()`` or the opening of ``recording()`` (the recorder's only
synchronisation before ``snapshot()``). ``count(name, n)`` adds to a
counter of the outermost open span (``("newton.iters_run", "refine")``): a
number on the host, or a tensor (a count the device makes) into a static
int64 accumulator on its device.

A span opened while a CUDA graph is captured records its events as nodes
of the graph (``external``), which every replay re-times on the device with
no host involvement; ``snapshot()`` reads the last replay's times. The span
calls and host counts made while capturing are kept with the graph and
added at each replay (utils/graphs.py::Captured), as the kernel wrappers'
launches are. A device count's accumulator is made outside a capture: a
captured body runs eagerly once first (utils/graphs.py::PassRunner does).

``snapshot()`` synchronises once and returns the spans and counters since
the last ``reset()``. Nothing records while dynamo traces a program
(utils/export.py).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


class _Section:
    """Handle yielded by ``Timings.section``: register the section's device
    outputs with ``hold(...)`` so the exit sync waits for them."""

    def __init__(self):
        self._held: list = []

    def hold(self, *tensors):
        """Register tensors (or tuples of them, e.g. a CoresetState) whose
        completion ends the section. Returns the single argument (or the
        tuple) for inline use: ``st = s.hold(build(...))``."""
        self._held.extend(tensors)
        return tensors[0] if len(tensors) == 1 else tensors


def _cuda_devices(objs) -> set:
    found = set()
    for x in objs:
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.add(x.device)
        elif isinstance(x, (tuple, list)):
            found |= _cuda_devices(x)
        elif isinstance(x, dict):
            found |= _cuda_devices(x.values())
    return found


class Timings:
    """Accumulates named wall-clock sections; saves the reference-style
    ``*_time.npy`` artifact plus a JSON summary."""

    def __init__(self):
        self.sections: Dict[str, list] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = True):
        s = _Section()
        t0 = time.perf_counter()
        yield s
        if sync:
            devices = _cuda_devices(s._held)
            if not s._held and torch.cuda.is_available() and torch.cuda.is_initialized():
                devices = {torch.device("cuda", torch.cuda.current_device())}
            for dev in devices:
                torch.cuda.synchronize(dev)
        self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return float(np.sum(self.sections.get(name, [0.0])))

    def save(self, path_prefix: str) -> None:
        for name, vals in self.sections.items():
            np.save(f"{path_prefix}_{name}_time.npy", np.asarray(vals))
        with open(f"{path_prefix}_timings.json", "w") as f:
            json.dump({k: {"total_s": float(np.sum(v)), "n": len(v),
                           "mean_s": float(np.mean(v))}
                       for k, v in self.sections.items()}, f, indent=2)

    def summary(self) -> str:
        return "; ".join(f"{k}: {self.total(k):.2f}s/{len(v)}"
                         for k, v in self.sections.items())


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the body (the CPU, and the card when
    there is one), written to ``logdir`` as ``trace_<pid>_<ns>.json``
    (Chrome's trace format; chrome://tracing or Perfetto read it). Yields
    the profiler (``key_averages()``), or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))




class Span(NamedTuple):
    """A span of ``snapshot()``: every call of ``name`` opened directly
    under a span named ``parent`` (None: under none), run by the host or
    (``captured``) by the replays of captured graphs. ``calls``: how often
    it ran, once a replay when captured. Times are those of the last call,
    in ``time.time_ns()`` nanoseconds: no host times when captured, no
    device times without CUDA. ``device_ms``: the time between its two
    device events."""

    name: str
    parent: Optional[str]
    calls: int
    captured: bool
    host_start_ns: Optional[int]
    host_end_ns: Optional[int]
    device_start_ns: Optional[int]
    device_end_ns: Optional[int]
    device_ms: Optional[float]


class Snapshot(NamedTuple):
    spans: list         # Span, in the order they first opened
    counters: dict      # (name, outermost span open at the count, or None) -> int


class Recorded(NamedTuple):
    """What a captured graph recorded, added at every replay: the host
    counts made while capturing, and ((name, parent, True), events, device)
    of each span opened in it."""

    counters: collections.Counter
    spans: list


class _Aggregate:
    """The calls of one (name, parent, captured) and the events of the last."""

    __slots__ = ("device", "calls", "events", "host_start", "host_end")

    def __init__(self, device: Optional[int]):
        self.device = device
        self.calls = 0
        self.events = self.host_start = self.host_end = None

    def read(self, key: tuple, anchors: dict) -> Span:
        start = end = ms = None
        if self.events is not None and all(ev.query() for ev in self.events):
            ms = self.events[0].elapsed_time(self.events[1])
            anchor = anchors.get(self.device)
            if anchor is not None:
                start, end = (_on_host_clock(anchor, ev) for ev in self.events)
        name, parent, captured = key
        return Span(name, parent, self.calls, captured, self.host_start, self.host_end,
                    start, end, ms)


class _Recorder:
    def __init__(self):
        self.spans: dict = {}           # (name, parent, captured) -> _Aggregate
        self.counters = collections.Counter()   # (name, scope) -> n
        self.device_counters: dict = {}     # (name, scope, device) -> 0-d int64 accumulator
        self.anchors: dict = {}         # CUDA device index -> (host ns, event)
        self.stack: list = []           # names of the open spans, innermost last
        self.pending: list = []         # spans opened while a graph is captured


_REC = _Recorder()
_depth = 0          # of recording()
_OFF = contextlib.nullcontext()


def active() -> bool:
    """Whether the recorder is on: inside ``recording()`` or while a torch
    profiler runs, never while dynamo traces. Off, two module flags read."""
    return ((_depth > 0 or _autograd_profiler._is_profiler_enabled)
            and not torch.compiler.is_compiling())


@contextlib.contextmanager
def recording():
    """The recorder on for the body, whether a profiler runs or not. Its
    opening anchors the device clocks anew."""
    global _depth
    if _depth == 0:
        _REC.anchors.clear()
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def _cuda_device() -> Optional[int]:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_device()
    return None


def _anchor(dev: int):
    """(host ns, event) pinning device ``dev``'s event clock to
    ``time.time_ns()``: an event recorded on the idle device after a
    synchronisation, stamped at the middle of the host's wait for it (its
    first record, which creates it, is not the one timed)."""
    got = _REC.anchors.get(dev)
    if got is None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize(dev)
        t0 = time.time_ns()
        ev.record()
        ev.synchronize()
        got = _REC.anchors[dev] = ((t0 + time.time_ns()) // 2, ev)
    return got


def _on_host_clock(anchor, event) -> int:
    host_ns, ev = anchor
    return host_ns + round(ev.elapsed_time(event) * 1e6)


def device_ns(event) -> Optional[int]:
    """A completed CUDA event's time on the host's clock, through the
    anchor of the current device (None with CUDA not in use)."""
    dev = _cuda_device()
    return None if dev is None else _on_host_clock(_anchor(dev), event)


def _range(name: str):
    # a function-scope range: the profiler lists it as a host operation and,
    # unlike a user-scope ``record_function``, draws no copy of it over the
    # device's kernels, so a trace's device operations stay the device's own
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return torch.profiler.record_function(name) if fast is None else fast(name)


def _timing_events(external: bool) -> tuple:
    return tuple(torch.cuda.Event(enable_timing=True, external=external) for _ in range(2))


class _Span:
    """``annotate``'s span while the recorder is on."""

    __slots__ = ("name", "agg", "events", "capturing", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        R = _REC
        dev = _cuda_device()
        capturing = dev is not None and torch.cuda.is_current_stream_capturing()
        key = (self.name, R.stack[-1] if R.stack else None, capturing)
        agg = R.spans.get(key)
        if agg is None:
            agg = R.spans[key] = _Aggregate(dev)
        if dev is not None and agg.events is None:
            agg.events = _timing_events(external=capturing)
        if capturing:
            R.pending.append((key, agg.events, dev))
        else:
            agg.calls += 1
            if dev is not None:
                _anchor(dev)
            agg.host_start = time.time_ns()
        self.agg, self.events, self.capturing = agg, agg.events, capturing
        R.stack.append(self.name)
        self.range = _range(self.name)
        self.range.__enter__()
        if self.events is not None:
            torch.cuda.nvtx.range_push(self.name)
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
            torch.cuda.nvtx.range_pop()
        self.range.__exit__(*exc)
        if not self.capturing:
            self.agg.host_end = time.time_ns()
        _REC.stack.pop()
        return False


def annotate(name: str):
    """A span named ``name`` over the body (module docstring): with the
    recorder on, a range in a ``trace``'s (or any profiler's) timeline, an
    NVTX range when CUDA is in use, and a record; off, nothing."""
    return _Span(name) if active() else _OFF


def spanned(name: str):
    """Decorator: each call of the function in ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not active():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n=1) -> None:
    """Adds ``n`` to counter ``name`` of the outermost open span while the
    recorder is on: a number on the host, or a tensor into its device's
    accumulator (a captured graph adds it at every replay)."""
    if not active():
        return
    R = _REC
    key = (name, R.stack[0] if R.stack else None)
    if not isinstance(n, torch.Tensor):
        R.counters[key] += n
        return
    _accumulator(name, key, n.device).add_(n.to(torch.int64))


def reserve(name: str, device) -> None:
    """Makes counter ``name``'s accumulator of the outermost open span on
    ``device`` while the recorder is on, for a later capture of a body that
    counts into it but runs eagerly without a device count."""
    if active():
        _accumulator(name, (name, _REC.stack[0] if _REC.stack else None), torch.device(device))


def _accumulator(name: str, key: tuple, device: torch.device) -> torch.Tensor:
    acc = _REC.device_counters.get((*key, device))
    if acc is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"count({name!r}): a device count first made inside a CUDA "
                               "graph capture; run the body eagerly once before capturing it")
        acc = _REC.device_counters[(*key, device)] = torch.zeros((), dtype=torch.int64,
                                                                device=device)
    return acc


def capture_mark() -> tuple:
    """Where the recorder stands before a graph capture (``captured_since``)."""
    return collections.Counter(_REC.counters), len(_REC.pending)


def captured_since(mark: tuple) -> Optional[Recorded]:
    """What the capture since ``mark`` recorded, or None. Capturing runs
    nothing, so its host counts are set back; ``replayed`` adds them."""
    before, n = mark
    spans = _REC.pending[n:]
    del _REC.pending[n:]
    made = _REC.counters - before
    _REC.counters = before
    return Recorded(made, spans) if made or spans else None


def replayed(recorded: Recorded) -> None:
    """One replay of a graph that recorded ``recorded``, while the recorder
    is on: its counts added, one call more of each of its spans."""
    if not active():
        return
    R = _REC
    R.counters.update(recorded.counters)
    for key, events, dev in recorded.spans:
        agg = R.spans.get(key)
        if agg is None:
            agg = R.spans[key] = _Aggregate(dev)
        agg.events = events
        agg.calls += 1


def snapshot() -> Snapshot:
    """The spans that ran and the counters since the last ``reset()``,
    after one synchronisation of each CUDA device they were recorded on. A
    device counter that reads 0 is left out."""
    R = _REC
    ran = [(key, agg) for key, agg in R.spans.items() if agg.calls]
    devices = {agg.device for _, agg in ran if agg.device is not None}
    devices |= {d.index for *_, d in R.device_counters if d.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
        _anchor(dev)
    counters = dict(R.counters)
    for (name, scope, _), acc in R.device_counters.items():
        n = int(acc)
        if n:
            counters[(name, scope)] = counters.get((name, scope), 0) + n
    return Snapshot([agg.read(key, R.anchors) for key, agg in ran], counters)


def reset() -> None:
    """Drops the spans and zeroes the counters; the next span anchors the
    device clocks anew."""
    R = _REC
    R.spans.clear()
    R.counters.clear()
    R.anchors.clear()
    for acc in R.device_counters.values():
        acc.zero_()
