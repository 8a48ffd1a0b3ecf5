"""The captured Newton loop (betacores_tpu_torch/inference/laplace.py) on the
card: each iteration the body of a CUDA-graph conditional node, nested, so
that a replay stops where the fit is done. A captured refit, replayed,
equals the eager fixed-count loop bit for bit on every case of
tests/laplace_cases.py (logistic with and without L^-1, multiclass K = 5,
Poisson; cold, warm and near starts; the indefinite Hessian and the
non-improving step), and runs exactly the iterations the fit needs; one
graph replayed from other starts runs another number of iterations each
time; and graphs captured one after another keep working past the stream
pool's wrap. This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_laplace_cuda.py

Without a card its tests skip."""

import pytest
import torch

import laplace_cases as lc
from betacores_tpu_torch.utils import graphs, profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: conditional graph nodes")
    profiling.reset()
    yield torch.device("cuda")
    profiling.reset()


def _captured(refit):
    """``refit.fit()`` captured as one graph, and the fit its replays write."""
    out = []
    prog = graphs.capture(lambda: out.append(refit.fit()))
    return prog, out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,start", lc.CASES)
def test_a_replayed_refit_equals_the_fixed_count_loop(card, case, start, dtype):
    refit = lc.case_refit(case, start, card, dtype)
    mu0 = refit.mu0.clone()
    refit.fit()                                 # eager first: handles, caches
    plain_prog, plain = _captured(refit)        # the recorder off: no counts
    with profiling.recording():
        eager = refit.fit()                     # and the device counters
        needed, executed = lc.counts()
        assert executed == refit.n_iters
        lc.expect(start, needed, refit.n_iters)
        prog, fit = _captured(refit)
        profiling.reset()
        prog.replay()
        plain_prog.replay()
        # one body ran for each iteration entered undone, and no other
        assert lc.counts() == (needed, needed)
    assert lc.same(fit, eager) and lc.same(plain, eager)
    assert torch.equal(refit.mu0, mu0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", lc.FAMILIES)
def test_one_graph_replayed_from_other_starts(card, family):
    """The graph captured from one start, replayed from others: each replay
    runs that start's iterations and gives its fit."""
    refit, mode = lc.family_refit(family, card, torch.float32)
    starts = ("near", "warm", "cold", "near")
    want = []
    with profiling.recording():
        for name in starts:
            refit.mu0.copy_(lc.start(mode, name))
            profiling.reset()
            want.append((refit.fit(), lc.counts()[0]))
        prog, fit = _captured(refit)
        for name, (eager, needed) in zip(starts, want):
            refit.mu0.copy_(lc.start(mode, name))
            profiling.reset()
            prog.replay()
            assert lc.same(fit, eager)
            assert lc.counts() == (needed, needed)
    assert len({needed for _, needed in want}) == 3


@pytest.mark.cuda
def test_many_captures_in_a_row(card):
    """Sixteen multiclass refits of twelve nested bodies each, captured one
    after another: every capture succeeds and every replay is right."""
    refit, mode = lc.family_refit("multiclass", card, torch.float32)
    refit.mu0.copy_(lc.start(mode, "cold"))
    eager = refit.fit()
    progs = [_captured(refit) for _ in range(16)]
    for prog, fit in progs:
        prog.replay()
        assert lc.same(fit, eager)
