"""The traced window: torch.profiler over a fixed number of whole selections,
and the arithmetic that reads it.

The device's busy time (the result's ``busy_s``) is the union of the
intervals in which an operation (a kernel, a copy or a fill) ran on the
card: the arithmetic of tools/profile_build.py, copied. The profiler's own
stalls lengthen the profiled window, so its idle share is the traced
program's, not the untraced one's. The breakdown lists the device operations
that took most time, by name, and the idle gaps of the device timeline,
each named by the benchmark's span the host was in (``bench.select``,
``bench.refine``, or none) when the gap began. Nothing is written to disk.
"""

from __future__ import annotations

import collections
import time
import warnings
from typing import NamedTuple

import torch

SPAN_PREFIX = "bench."
TOP = 10


class TraceData(NamedTuple):
    """Device operations (name, start_ns, end_ns), the benchmark's host spans
    (name, start_ns, end_ns), and the profiled window's wall seconds."""

    ops: list
    spans: list
    wall_s: float


def _ns(event, which: str) -> int:
    got = getattr(event, f"{which}_ns", None)
    if got is not None:
        return int(got())
    return int(getattr(event, f"{which}_us")() * 1000)


class Profiled:
    """``start()`` and ``stop()`` around whole selections; each waits for
    the card, so the window holds exactly their work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.data = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def start(self) -> None:
        """Starts the profiler; the window's clock starts once it runs."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Stops the window's clock once the card is done, then the profiler."""
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.prof.stop()

    def read(self) -> TraceData:
        """The trace's device operations and host spans (read once the
        window has closed)."""
        if self.data is not None:
            return self.data
        ops, spans = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the device-side copy of a host span carries the span's name
                if name.startswith(SPAN_PREFIX):
                    continue
                ops.append((name, _ns(e, "start"), _ns(e, "end")))
            elif name.startswith(SPAN_PREFIX):
                spans.append((name[len(SPAN_PREFIX):], _ns(e, "start"), _ns(e, "end")))
        self.prof = None
        self.data = TraceData(sorted(ops, key=lambda o: o[1]), sorted(spans, key=lambda s: s[1]),
                              self.wall_s)
        return self.data


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, as disjoint sorted (start, end)."""
    out = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def busy_seconds(ops) -> float:
    return sum(b - a for a, b in busy_intervals(ops)) / 1e9


def _span_at(spans, t: int) -> str:
    for name, a, b in spans:
        if a <= t < b:
            return name
    return "none"


def breakdown(data: TraceData) -> dict:
    """The device operations that took most time (seconds summed by name)
    and the idle gaps of the device timeline: first the idle seconds summed
    by the host span each gap began in ("total.<span>"), then the longest
    gaps ("gap.<span>"), at most TOP entries each."""
    by_name = collections.Counter()
    for name, a, b in data.ops:
        by_name[name[:120]] += (b - a) / 1e9
    ivs = busy_intervals(data.ops)
    gaps = [(ivs[i][1], ivs[i + 1][0] - ivs[i][1]) for i in range(len(ivs) - 1)]
    named = [(_span_at(data.spans, t), g / 1e9) for t, g in gaps]
    totals = collections.Counter()
    for name, g in named:
        totals[name] += g
    idle = [[f"total.{n}", s] for n, s in totals.most_common()]
    longest = sorted(named, key=lambda x: -x[1])[:max(0, TOP - len(idle))]
    idle += [[f"gap.{n}", s] for n, s in longest]
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": idle[:TOP]}
