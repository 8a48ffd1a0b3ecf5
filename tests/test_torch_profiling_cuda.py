"""The port's spans and counters (betacores_tpu_torch/utils/profiling.py) on
the card: a span inside a captured step is timed by every replay; recording
captures a graph of its own per step key and leaves the unrecorded one in
place; a warm build makes no host synchronisation with the recorder off;
the pass runner counts launches made after the stream ran dry; and builds
are bit-identical with recording on and off on each refinement route. This
file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_profiling_cuda.py

Without a card its tests skip."""

import pytest
import torch

from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.utils import graphs, profiling
from test_torch_profiling import ROUTES, draws, make_route, tiny_build


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device times are CUDA events")
    profiling.reset()
    yield torch.device("cuda")
    profiling.reset()


@pytest.mark.cuda
def test_a_captured_newton_span_is_timed_by_each_replay(card):
    gen = torch.Generator(device=card).manual_seed(0)
    pts = torch.randn((300, 10), generator=gen, device=card) + 0.5
    wts = torch.rand(300, generator=gen, device=card)
    aux = torch.zeros(10, device=card)
    sampler = logreg_laplace_sampler()

    def step():
        with profiling.annotate("step"):
            sampler.fit(wts, pts, aux)

    runner = graphs.PassRunner(graph=True)
    with profiling.recording():
        for _ in range(4):
            runner.run("k", step)
    snap = profiling.snapshot()
    spans = {(s.name, s.parent, s.captured): s for s in snap.spans}
    assert set(spans) == {("step", None, False), ("newton", "step", False),
                          ("step", None, True), ("newton", "step", True)}
    outer, newton = spans["step", None, True], spans["newton", "step", True]
    # run eagerly once, then captured and replayed three times: the last
    # replay's times
    assert newton.calls == outer.calls == 3
    assert spans["step", None, False].calls == spans["newton", "step", False].calls == 1
    assert 0 < newton.device_ms < outer.device_ms
    assert outer.device_start_ns <= newton.device_start_ns < newton.device_end_ns
    assert newton.device_end_ns <= outer.device_end_ns
    assert snap.counters[("newton.iters_run", "step")] == 4 * 8
    assert 0 < snap.counters[("newton.iters_needed", "step")] <= 4 * 8


@pytest.mark.cuda
def test_recording_captures_one_more_graph_per_key(card):
    b, st0 = make_route("k1", card)
    b.build(st0, 3, draws(b, card))
    runner = b._fused.runner
    before = dict(runner.programs)
    assert before and all(len(k) == 2 for k in before)
    with profiling.recording():
        b.build(st0, 3, draws(b, card))
    recorded = {k for k in runner.programs if k not in before}
    assert recorded == {(*k, "recorded") for k in before}
    assert all(runner.programs[k] is g for k, g in before.items())
    assert all(isinstance(runner.programs[k], graphs.Captured) for k in recorded)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_a_warm_build_makes_no_host_sync_with_recording_off(card, route):
    b, st0 = make_route(route, card)
    b.build(st0, 3, draws(b, card))
    d = draws(b, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = st0
        for it in range(3):
            st = b.optimize(b.select(st, d, it), d, it)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_launches_after_the_stream_ran_dry_are_counted(card):
    x = torch.ones(8, device=card)
    runner = graphs.PassRunner(graph=True)
    with profiling.recording():
        runner.run_pass(50, lambda key: x.mul_(1.0))
    c = {name: n for (name, _), n in profiling.snapshot().counters.items()}
    assert c["pass.replays"] == 49 and list(runner.programs) == [("step", 0, "recorded")]
    # a one-kernel step ends long before the host has launched the next
    assert 0 < c["pass.dry_launches"] <= 48
    assert c["pass.host_gap_ns"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_builds_are_bit_identical_with_recording_on_and_off(card, route):
    _, off = tiny_build(route, card)
    with profiling.recording():
        _, on = tiny_build(route, card)
    assert torch.equal(on.wts, off.wts) and torch.equal(on.idcs, off.idcs)
    assert torch.equal(on.m, off.m)
    spans = profiling.snapshot().spans
    assert any(s.name == "newton" and s.parent == "refine" and s.captured and s.device_ms > 0
               for s in spans)
