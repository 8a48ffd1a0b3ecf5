"""Refinement passes as device-resident programs (what ``jax.jit`` over
``lax.scan`` is to the reference's build).

A refinement pass is T dependent steps, each a few hundred small device
operations. Dispatched one by one from Python the host paces the card, so
on a CUDA device a builder captures its step body as a CUDA graph and
replays it. That needs

- static buffers: everything a step reads or carries lives at a fixed
  address, filled with ``copy_`` before the pass (the builders keep them);
- a step body that depends on the step index only through a device-side
  counter and through ``step_key(i)``, the host-side schedule (for one,
  "this step refits the posterior"): steps with equal keys replay one graph.

``PassRunner`` runs a pass one step per graph: a graph of one step
instantiates in milliseconds, and the host replays far faster than the card
runs a step, so a longer graph buys nothing (PERF.md has both measured).
The first run of a step with a new key is eager (which also creates the
library handles and workspaces a capture may not create), the second is
captured, and every later one replays. With ``graph=False`` (the CPU, or a
caller that asks for it) every step runs eagerly, through the same body.
A capture or a replay that fails raises: nothing falls back to the eager
loop.

A step that draws from a ``torch.Generator`` of its own (the per-step-draw
route of coresets/incremental.py) names it in the runner's ``generators``:
each capture registers it with its graph, so every replay advances it as
the eager step would and draws what the eager step would draw.

A captured kernel launch runs no Python, so the wrappers' launch counts
(``counted``) and a mesh's collective counts are taken while capturing
(which launches nothing, so they are set back) and added at every replay.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Hashable, Optional

import torch

# the kernel wrappers whose ``launches`` a replay keeps truthful
_COUNTED: list = []


def counted(wrapper):
    """Registers a kernel wrapper: gives it ``launches = 0``, which the
    wrapper adds one to wherever it launches its kernel."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def resolve_graph(graph: Optional[bool], device) -> bool:
    """Whether a builder on ``device`` captures its passes: ``None`` means
    captured on a CUDA device and eager elsewhere; ``True`` off a CUDA
    device raises."""
    on_card = torch.device(device).type == "cuda"
    if graph is None:
        return on_card
    if graph and not on_card:
        raise ValueError(f"graph=True needs a CUDA device, the data is on {device}")
    return bool(graph)


def signature(tensors) -> tuple:
    """(shape, dtype, device) of each tensor: what static buffers made for
    these tensors depend on."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


class Captured:
    """A captured graph with what it launches: ``launches`` pairs each
    counted wrapper with its launches in the graph, ``captured_calls`` are
    the collectives in it (added to ``calls``). ``replay`` replays the
    graph and adds both."""

    def __init__(self, graph, launches, calls=None, captured_calls=None):
        self.graph, self.launches = graph, launches
        self.calls, self.captured_calls = calls, captured_calls

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        if self.calls is not None:
            self.calls.update(self.captured_calls)


def capture(fn: Callable[[], None],
            calls: Optional[collections.Counter] = None, generators=()) -> Captured:
    """``fn()`` captured as one CUDA graph on the current device, with the
    ``generators`` it draws from registered. Capturing launches nothing, so
    the counts ``fn`` advanced are set back and kept for the replays."""
    before = [w.launches for w in _COUNTED]
    calls_before = None if calls is None else collections.Counter(calls)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        fn()
    launches = [(w, w.launches - b) for w, b in zip(_COUNTED, before) if w.launches != b]
    for w, b in zip(_COUNTED, before):
        w.launches = b
    captured_calls = None
    if calls is not None:
        captured_calls = collections.Counter(calls) - calls_before
        calls.clear()
        calls.update(calls_before)
    return Captured(graph, launches, calls, captured_calls)


def capture_stats(passes) -> tuple:
    """(graphs captured, host seconds spent capturing them) over the
    runners of ``passes`` (a builder's pass objects, None where a route
    has not run)."""
    runners = [p.runner for p in passes if p is not None]
    return (sum(isinstance(g, Captured) for r in runners for g in r.programs.values()),
            sum(r.capture_seconds for r in runners))


class PassRunner:
    """Runs refinement passes step by step: eagerly, or (``graph``) as
    replayed CUDA graphs of one step each. ``calls`` is a mesh's collective
    counter, when the steps run collectives."""

    def __init__(self, graph: bool, calls: Optional[collections.Counter] = None):
        self.graph, self.calls = graph, calls
        self.generators: tuple = ()     # the steps' own generators
        self.programs: dict = {}        # key -> None (run once, eagerly) or Captured
        self.capture_seconds = 0.0      # host time spent capturing and instantiating

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """``fn()``: eagerly the first time ``key`` is seen, captured the
        second, replayed from then on."""
        if not self.graph:
            fn()
            return
        if key not in self.programs:
            self.programs[key] = None
            fn()
            return
        if self.programs[key] is None:
            t0 = time.perf_counter()
            self.programs[key] = capture(fn, self.calls, self.generators)
            self.capture_seconds += time.perf_counter() - t0
        self.programs[key].replay()

    def run_pass(self, n_steps: int, step: Callable[[Hashable], None],
                 step_key: Callable[[int], Hashable] = lambda i: 0) -> None:
        """``step(step_key(i))`` for i = 0..n_steps-1. The body may depend
        on i only through its key and a counter it keeps on the device."""
        for i in range(n_steps):
            key = step_key(i)
            self.run(("step", key), lambda: step(key))
