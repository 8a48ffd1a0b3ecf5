"""The port's spans and counters (betacores_tpu_torch/utils/profiling.py) on
the CPU: the recorder is off unless a profiler runs or ``recording()`` is
on, and then makes nothing; builds are bit-identical with it on and off on
each refinement route; spans nest and share the profiler's clock; the
Newton counters; one aggregate per span name and parent, so the store stays
bounded; and the pass runner's keys and
the counts it carries through a captured graph (with a stand-in graph: the
CPU has none). tests/test_torch_profiling_cuda.py holds the rest on the
card. ``make_route``, ``draws`` and ``tiny_build`` are shared with it."""

import contextlib

import pytest
import torch

from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                          make_incremental_builder)
from betacores_tpu_torch.coresets.groups import (init_group_state,
                                                 make_group_incremental_builder)
from betacores_tpu_torch.inference import (logreg_laplace_sampler,
                                           multiclass_laplace_sampler)
from betacores_tpu_torch.inference.laplace import newton_laplace
from betacores_tpu_torch.models import logreg, multiclass
from betacores_tpu_torch.ops.projection import Groups
from betacores_tpu_torch.utils import graphs, profiling

ROUTES = ("k1", "composed", "group_exact")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    assert not profiling.active()
    yield
    profiling.reset()


def make_route(route: str, device, seed: int = 0):
    """A small builder on one refinement route and its empty state: ``k1``
    the logistic fused step (K1, its plain version on the CPU),
    ``composed`` the multiclass composed pass on a subsample,
    ``group_exact`` the logistic group build with the exact gradient over
    every row."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    cfg = dict(projection_dim=16, n_subsample_select=200, n_subsample_opt=50, opt_itrs=6,
               use_beta=True)
    if route == "composed":
        K, d = 3, 3
        x = torch.randn((3000, d), **kw)
        y = torch.randint(0, K, (3000, 1), **kw).to(torch.float32)
        data, model = torch.cat([x, y], dim=1), multiclass.bundle(K)
        sampler, p = multiclass_laplace_sampler(K), K * d
    else:
        data = torch.randn((3000, 3), **kw) + 0.5
        model, sampler, p = logreg.bundle(), logreg_laplace_sampler(), 3
    aux = torch.zeros(p, device=device)
    if route != "group_exact":
        b = make_incremental_builder(data, model, sampler, IncrementalConfig(**cfg))
        return b, init_state(12, data.shape[1], beta=0.2, sampler_aux=aux, device=device)
    G, per = 30, 100
    groups = Groups(members=torch.arange(G * per, device=device).reshape(G, per),
                    sizes=torch.full((G,), per, dtype=torch.int64, device=device))
    cfg.update(n_subsample_select=None, n_subsample_opt=None)
    b = make_group_incremental_builder(data, groups, model, sampler, IncrementalConfig(**cfg))
    return b, init_group_state(init_state(2 * per, data.shape[1], beta=0.2, sampler_aux=aux,
                                          device=device), G)


def draws(b, device):
    return b.generator_draws(torch.Generator(device=device).manual_seed(1))


def tiny_build(route: str, device, selections: int = 3):
    """A build of ``selections`` on ``make_route``'s builder: (builder,
    final point state)."""
    b, st0 = make_route(route, device)
    st = b.build(st0, selections, draws(b, device))
    assert (b._fused is not None) == (route == "k1")
    return b, getattr(st, "core", st)


def _same(a, b) -> None:
    assert torch.equal(a.wts, b.wts) and torch.equal(a.idcs, b.idcs) and torch.equal(a.m, b.m)


def test_off_by_default_makes_no_range_event_or_record(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("made while the recorder is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    with profiling.annotate("off"):
        profiling.count("off.count", 3)
    tiny_build("k1", "cpu", selections=1)
    snap = profiling.snapshot()
    assert snap.spans == [] and snap.counters == {}


@pytest.mark.parametrize("route", ROUTES)
def test_builds_are_bit_identical_with_recording_on_and_off(route):
    _, off = tiny_build(route, "cpu")
    with profiling.recording():
        _, on = tiny_build(route, "cpu")
    _same(on, off)
    snap = profiling.snapshot()
    assert {(s.name, s.parent) for s in snap.spans} >= {("refine", None), ("newton", "refine")}
    assert snap.counters[("newton.iters_run", "refine")] > 0


@pytest.mark.parametrize("route", ROUTES)
def test_spans_nest_and_a_repeated_refit_keeps_one_record(route):
    with profiling.recording():
        tiny_build(route, "cpu", selections=1)
    snap = profiling.snapshot()
    spans = {(s.name, s.parent): s for s in snap.spans}
    assert len(spans) == len(snap.spans) == 3
    refine, refit, select_fit = (spans[k] for k in (("refine", None), ("newton", "refine"),
                                                    ("newton", None)))
    # the select's own fit, then one refit a step for six steps, run
    # eagerly: one aggregate of six calls under refine
    assert refine.calls == 1 and refit.calls == 6 and select_fit.calls == 1
    assert refine.host_start_ns <= refit.host_start_ns <= refit.host_end_ns <= refine.host_end_ns
    assert select_fit.host_end_ns <= refine.host_start_ns
    assert all(s.device_ms is None and not s.captured for s in snap.spans)
    n_newton = 12 if route == "composed" else 8
    # a count belongs to the outermost open span: the pass's refits to
    # refine, the select's fit (counted after its span closes) to none
    assert snap.counters[("newton.iters_run", "refine")] == 6 * n_newton
    assert snap.counters[("newton.iters_run", None)] == n_newton
    needed = snap.counters[("newton.iters_needed", "refine")]
    assert 0 < needed <= 6 * n_newton


def test_a_span_starts_with_its_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.active()
        with profiling.annotate("warm-up"):
            pass
        with profiling.annotate("timed"):
            pass
    assert not profiling.active()
    (span,) = [s for s in profiling.snapshot().spans if s.name == "timed"]
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "timed"]
    assert 0 <= event.start_ns() - span.host_start_ns < 100_000
    assert span.host_end_ns >= event.end_ns()


def _newton_counts(log_joint, grad, hess, mu0, calls=2, n_iters=8):
    with profiling.recording():
        for _ in range(calls):
            newton_laplace(log_joint, grad, hess, mu0, n_iters=n_iters)
    c = profiling.snapshot().counters
    profiling.reset()
    return c.get(("newton.iters_needed", None), 0), c[("newton.iters_run", None)]


def test_newton_counts_the_iterations_entered_undone():
    d = 4
    A = torch.eye(d, dtype=torch.float64) * 2.0 + 0.3
    c = torch.linspace(-1.0, 1.0, d, dtype=torch.float64)

    def quad(th):
        r = th - c
        return -0.5 * ((r @ A) * r).sum(-1)

    grad, hess = (lambda th: -(A @ (th - c))), (lambda th: -A)
    zero = torch.zeros(d, dtype=torch.float64)
    # a quadratic: the first full Newton step lands on the mode, so one
    # iteration of eight is entered undone a call
    assert _newton_counts(quad, grad, hess, zero) == (2, 16)
    # started at the mode: done before the loop
    assert _newton_counts(quad, grad, hess, c.clone()) == (0, 16)
    # a linear log joint with a fixed curvature: every step improves and the
    # decrement never falls, so every iteration is entered undone
    ones = torch.ones(d, dtype=torch.float64)
    assert _newton_counts(lambda th: th.sum(-1), lambda th: ones,
                          lambda th: -torch.eye(d, dtype=torch.float64), zero,
                          n_iters=5) == (10, 10)


def test_the_records_stay_bounded():
    with profiling.recording():
        for i in range(5000):
            with profiling.annotate("a" if i % 2 else "b"):
                with profiling.annotate("inner"):
                    pass
        for _ in range(50):
            with profiling.annotate("same"):
                pass
    spans = {(s.name, s.parent): s.calls for s in profiling.snapshot().spans}
    # one aggregate per name and parent, however many calls
    assert spans == {("b", None): 2500, ("inner", "b"): 2500, ("a", None): 2500,
                     ("inner", "a"): 2500, ("same", None): 50}
    assert len(profiling._REC.spans) == 5


class _StandInGraph:
    """A graph that runs nothing: the CPU cannot capture."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass


class _StandInEvent:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def query(self):
        return False


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)


def test_recording_steps_take_a_key_of_their_own(stand_in_graphs):
    ran = []

    def step(key):
        ran.append(key)
        profiling.count("step.host")

    runner = graphs.PassRunner(graph=True)
    runner.run_pass(4, step)
    assert list(runner.programs) == [("step", 0)] and len(ran) == 2
    unrecorded = runner.programs[("step", 0)]
    assert profiling.snapshot().counters == {}
    with profiling.recording():
        runner.run_pass(4, step)
    assert list(runner.programs) == [("step", 0), ("step", 0, "recorded")]
    assert runner.programs[("step", 0)] is unrecorded and len(ran) == 4
    counters = profiling.snapshot().counters
    # eager, captured (its count set back) and replayed, replayed, replayed
    assert counters == {("pass.replays", None): 3, ("step.host", None): 4}
    runner.run_pass(2, step)
    assert profiling.snapshot().counters == counters and len(ran) == 4
