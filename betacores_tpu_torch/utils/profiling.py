"""Timed sections and traces (counterpart of betacores_tpu/utils/profiling.py).

``Timings`` accumulates named wall-clock sections. A CUDA launch returns
before the card has run it, so a section ends by synchronising the devices
of the tensors registered with ``hold`` (or, with none registered, the
current card when CUDA is in use): its time is the work's, not the
enqueue's. ``save`` writes the reference's artifacts,
``<prefix>_<name>_time.npy`` per section and ``<prefix>_timings.json``.
``trace(logdir)`` runs a ``torch.profiler`` trace of the CPU and, with a
card, of the card, and writes it to ``logdir`` as a Chrome trace;
``annotate(name)`` names a range in it (and an NVTX range on the card).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import numpy as np
import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """A named range in a ``trace``'s timeline, and an NVTX range when CUDA
    is in use."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
