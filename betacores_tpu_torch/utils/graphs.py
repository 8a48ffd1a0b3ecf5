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

A data-dependent loop needs no host read either: the captured Newton refit
(inference/laplace.py) puts each iteration in a conditional node of the
graph, so a replay stops on the device where the fit is done, as the
reference's ``while_loop`` does; run eagerly, it runs its fixed count.

``PassRunner`` runs a pass one step per graph: a graph of one step
instantiates in milliseconds, and the host replays far faster than the card
runs a step, so a longer graph buys nothing (PERF.md has both measured).
The first run of a step with a new key is eager (which also creates the
library handles and workspaces a capture may not create, for every
operation a conditional body holds: the eager refit runs all of them), the
second is captured, and every later one replays. With ``graph=False`` (the CPU, or a
caller that asks for it) every step runs eagerly, through the same body.
A capture or a replay that fails raises: nothing falls back to the eager
loop. Python's garbage collector is off while a graph is captured.

A step that draws from a ``torch.Generator`` of its own (the per-step-draw
route of coresets/incremental.py) names it in the runner's ``generators``:
each capture registers it with its graph, so every replay advances it as
the eager step would and draws what the eager step would draw.

A captured kernel launch runs no Python, so the wrappers' launch counts
(``counted``), a mesh's collective counts and what the program's recorder
counted (utils/profiling.py: span calls and host counters) are taken while
capturing (which launches nothing, so they are set back) and added at every
replay.

While the recorder is on, a step runs under a key of its own (the step's
key and ``"recorded"``): it is run eagerly, captured and replayed as any
new key, with its spans' timing events and its device counts as nodes of
its graph, and the unrecorded step's graph stays as it was. Off, keys and
graphs are those of a runner with no recorder. A recorded replay also
counts ``pass.replays``, and when the previous step's end event has already
completed as the host launches (the stream ran dry) ``pass.dry_launches``
and the nanoseconds from that event to the launch, ``pass.host_gap_ns``:
the host-caused idle of the pass, read without a profiler.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc
import time
from typing import Callable, Hashable, Optional

import torch

from . import profiling

# the kernel wrappers whose ``launches`` a replay keeps truthful
_COUNTED: list = []
# the stream ``capture`` is capturing on, while it routes its allocations
_routed_stream: Optional[int] = None


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
    the collectives in it (added to ``calls``), ``recorded`` what the
    recorder counted in it (profiling.Recorded, or None). ``replay``
    replays the graph and adds all three."""

    def __init__(self, graph, launches, calls=None, captured_calls=None, recorded=None):
        self.graph, self.launches = graph, launches
        self.calls, self.captured_calls = calls, captured_calls
        self.recorded = recorded

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        if self.calls is not None:
            self.calls.update(self.captured_calls)
        if self.recorded is not None:
            profiling.replayed(self.recorded)


def capture(fn: Callable[[], None],
            calls: Optional[collections.Counter] = None, generators=()) -> Captured:
    """``fn()`` captured as one CUDA graph on the current device, with the
    ``generators`` it draws from registered. Capturing launches nothing, so
    the counts ``fn`` advanced are set back and kept for the replays. The
    capture stream's allocations go to the graph's own pool for the whole
    capture, so that ``fn`` may hold ``run_if`` nodes."""
    before = [w.launches for w in _COUNTED]
    calls_before = None if calls is None else collections.Counter(calls)
    mark = profiling.capture_mark()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    pool = None
    if torch.cuda.is_available():
        _conditional_lib()
        pool = torch.cuda.graph_pool_handle()
    # no garbage collection while capturing: a dead reference cycle that
    # holds an older graph, collected mid-capture, would destroy that graph
    # on the capturing device and so invalidate the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        capturing = torch.cuda.graph(graph) if pool is None else torch.cuda.graph(graph, pool=pool)
        with capturing, _routed(pool):
            fn()
    finally:
        if collecting:
            gc.enable()
    launches = [(w, w.launches - b) for w, b in zip(_COUNTED, before) if w.launches != b]
    for w, b in zip(_COUNTED, before):
        w.launches = b
    captured_calls = None
    if calls is not None:
        captured_calls = collections.Counter(calls) - calls_before
        calls.clear()
        calls.update(calls_before)
    return Captured(graph, launches, calls, captured_calls, profiling.captured_since(mark))


@contextlib.contextmanager
def _routed(pool):
    """Inside a capture into the graph's pool ``pool``, the current stream's
    allocations go to that pool whatever its capture sequence: ``run_if``
    restarts the sequence, and PyTorch routes by the sequence the capture
    began with. PyTorch's route is swapped for one by the stream, which the
    capture's end removes as it would have removed PyTorch's; the pool
    reference the new route takes is given back at once."""
    global _routed_stream
    if pool is None:
        yield
        return
    device = torch.cuda.current_device()
    torch._C._cuda_endAllocateToPool(device, pool)
    torch._C._cuda_beginAllocateCurrentStreamToPool(device, pool)
    torch._C._cuda_releasePool(device, pool)
    _routed_stream = torch.cuda.current_stream().cuda_stream
    try:
        yield
    finally:
        _routed_stream = None


@functools.cache
def _conditional_lib() -> ctypes.CDLL:
    from ..ops._build import load

    lib = load("graph_conditional")
    vp = ctypes.c_void_p
    lib.graph_conditional_init.argtypes = []
    lib.graph_if_begin.argtypes = [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(vp)]
    lib.graph_if_end.argtypes = [vp, vp, vp]
    for fn in (lib.graph_conditional_init, lib.graph_if_begin, lib.graph_if_end):
        fn.restype = ctypes.c_int
    _check(lib.graph_conditional_init(), "graph_conditional_init")
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def can_branch(x: torch.Tensor) -> bool:
    """Whether work on ``x`` is being captured by ``capture`` now, so that
    ``run_if`` may put some of it in a conditional node (never while dynamo
    traces a program)."""
    return (_routed_stream is not None and not torch.compiler.is_compiling() and x.is_cuda
            and torch.cuda.current_stream(x.device).cuda_stream == _routed_stream)


def run_if(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """``body()`` captured, inside ``capture``, as the body of a conditional
    node (csrc/graph_conditional.cu): a replay runs it only when the 1-element
    bool ``pred`` is true on the device there. The body may launch kernels,
    device copies and further ``run_if`` nodes; a tensor it makes is not
    read after it, and it records no event."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not can_branch(pred):
        raise ValueError("run_if takes a 1-element bool tensor on the device "
                         "that capture() is capturing")
    lib = _conditional_lib()
    stream = ctypes.c_void_p(_routed_stream)
    graph, node = ctypes.c_void_p(), ctypes.c_void_p()
    _check(lib.graph_if_begin(stream, ctypes.c_void_p(pred.data_ptr()), ctypes.byref(graph),
                              ctypes.byref(node)), "graph_if_begin")
    try:
        body()
    finally:
        _check(lib.graph_if_end(stream, graph, node), "graph_if_end")


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
        self.last_end = None            # the previous recorded replay's end event
        self.ends: tuple = ()           # two end events, used in turn

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """``fn()``: eagerly the first time ``key`` is seen, captured the
        second, replayed from then on (a recording step under a key of its
        own, module docstring)."""
        recorded = profiling.active()
        if recorded:
            key = (*key, "recorded") if isinstance(key, tuple) else (key, "recorded")
        if not self.graph or key not in self.programs:
            if self.graph:
                self.programs[key] = None
            if recorded:
                self.last_end = None
            fn()
            return
        if self.programs[key] is None:
            t0 = time.perf_counter()
            self.programs[key] = capture(fn, self.calls, self.generators)
            self.capture_seconds += time.perf_counter() - t0
        if recorded:
            self._replay_recorded(self.programs[key])
        else:
            self.programs[key].replay()

    def _replay_recorded(self, program: Captured) -> None:
        """A replay while recording, with its dry-launch count (module
        docstring)."""
        if self.last_end is not None and self.last_end.query():
            launch_ns = time.time_ns()
            profiling.count("pass.dry_launches")
            done_ns = profiling.device_ns(self.last_end)
            if done_ns is not None:
                profiling.count("pass.host_gap_ns", launch_ns - done_ns)
        program.replay()
        profiling.count("pass.replays")
        if not self.ends:
            self.ends = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        self.last_end = self.ends[1] if self.last_end is self.ends[0] else self.ends[0]
        self.last_end.record()

    def run_pass(self, n_steps: int, step: Callable[[Hashable], None],
                 step_key: Callable[[int], Hashable] = lambda i: 0) -> None:
        """``step(step_key(i))`` for i = 0..n_steps-1. The body may depend
        on i only through its key and a counter it keeps on the device."""
        self.last_end = None
        for i in range(n_steps):
            key = step_key(i)
            self.run(("step", key), lambda: step(key))
