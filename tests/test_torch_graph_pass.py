"""The port's refinement passes on static buffers (betacores_tpu_torch:
ops/kernels.py::FusedPass, coresets/incremental.py::_ComposedPass,
utils/graphs.py) on the CPU, where the step body that a card replays as a
CUDA graph runs eagerly in the same loop.

Against the JAX package under the JAX build's own draws (the replay recipes
of test_torch_incremental.py and test_torch_sharded.py; the JAX build
through its Pallas kernels in interpret mode): three selections of the
fused route (a refit every step and every 4th), of the composed route
(multiclass) and of the sharded fused route on a (2, 1) gloo mesh give the
same ``idcs`` and ``m`` and weights within 5e-3 * max(1, max|w|),
test_torch_incremental.py's tolerance. Then what only the restructured
code can get wrong: a builder's buffers are refilled, not stale, between
builds; ``graph`` resolves as documented; the runner's schedule (eager,
then captured, then replayed) and the accounting of launches and
collectives under replay, with stand-ins for the CUDA graph objects the
CPU cannot make."""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference.samplers import (logreg_laplace_sampler as jlr_sampler,
                                              multiclass_laplace_sampler as jmc_sampler)
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu.models import multiclass as jmc
from betacores_tpu.parallel import (make_mesh as jmake_mesh,
                                    make_sharded_incremental_builder as jsharded,
                                    shard_data as jshard_data)
from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                         make_incremental_builder, state_from_numpy,
                                         state_to_numpy)
from betacores_tpu_torch.inference import (logreg_laplace_sampler,
                                           multiclass_laplace_sampler)
from betacores_tpu_torch.models import logreg, multiclass
from betacores_tpu_torch.ops import kernels
from betacores_tpu_torch.utils import graphs
from test_torch_incremental import _assert_same_build, _np_state, replay_jax_draws
from test_torch_sharded import replay_sharded_draws
from torch_dist_worker import run_world

torch.set_num_threads(1)

N, D, M, S = 1500, 5, 15, 40
N_SUB, T, ITRS, BETA, I0 = 150, 25, 3, 0.2, 0.5
K, D_MC, N_MC = 3, 4, 900


@pytest.fixture(scope="module")
def problem():
    """The well-separated problem of tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return (y[:, None] * X).astype(np.float32)


@pytest.fixture(scope="module")
def mc_problem():
    rng = np.random.default_rng(17)
    Th = 2.0 * rng.normal(size=(K, D_MC))
    X = rng.normal(size=(N_MC, D_MC))
    y = np.argmax(X @ Th.T + rng.gumbel(size=(N_MC, K)), axis=1)
    return np.c_[X, y].astype(np.float32)


def _kw(**change):
    kw = dict(projection_dim=S, n_subsample_select=N_SUB, n_subsample_opt=N_SUB,
              opt_itrs=T, i0=I0, use_beta=True)
    kw.update(change)
    return kw


def _logreg_builder(problem, **change):
    return make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                    logreg_laplace_sampler(), IncrementalConfig(**_kw(**change)))


@pytest.mark.parametrize("refit_every", [1, 4])
def test_fused_pass_matches_jax(problem, refit_every):
    kw = _kw(refit_every=refit_every)
    key, st0 = jax.random.PRNGKey(3), jinit_state(M, D, beta=BETA,
                                                  sampler_aux=jnp.zeros(D, jnp.float32))
    jst = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jlr_sampler(),
                   JConfig(fused_grad_step=True, **kw)).build(key, st0, ITRS)
    builder = _logreg_builder(problem, refit_every=refit_every)
    assert builder.fstep is not None and not builder.graph
    draws = replay_jax_draws(key, st0, ITRS, jlr_sampler(), N, S, T, N_SUB, N_SUB)
    tst = builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS, draws)
    assert isinstance(builder._fused, kernels.FusedPass) and builder._composed is None
    _assert_same_build(state_to_numpy(tst), _np_state(jst))


@pytest.mark.parametrize("refit_every", [1, 2])
def test_composed_pass_matches_jax(mc_problem, refit_every):
    """The multiclass build refines through the composed route."""
    kw = _kw(refit_every=refit_every)
    key = jax.random.PRNGKey(21)
    st0 = jinit_state(M, D_MC + 1, beta=BETA, sampler_aux=jnp.zeros(K * D_MC, jnp.float32))
    jst = jbuilder(jnp.asarray(mc_problem), jmc.bundle(K), jmc_sampler(K),
                   JConfig(**kw)).build(key, st0, ITRS)
    builder = make_incremental_builder(torch.from_numpy(mc_problem), multiclass.bundle(K),
                                       multiclass_laplace_sampler(K), IncrementalConfig(**kw))
    draws = replay_jax_draws(key, st0, ITRS, jmc_sampler(K), N_MC, S, T, N_SUB, N_SUB)
    tst = builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS, draws)
    assert builder._composed is not None and builder._fused is None
    _assert_same_build(state_to_numpy(tst), _np_state(jst))


@pytest.mark.parametrize("refit_every", [1, 4])
def test_sharded_fused_pass_matches_jax(problem, refit_every, tmp_path):
    """The sharded fused route on a (2, 1) gloo mesh of spawned processes
    against the JAX sharded build through K3 (interpret mode)."""
    n_data, kw = 2, _kw(refit_every=refit_every)
    key, st0 = jax.random.PRNGKey(3), jinit_state(M, D, beta=BETA,
                                                  sampler_aux=jnp.zeros(D, jnp.float32))
    mesh = jmake_mesh(n_data, 1)
    ds, n_true = jshard_data(jnp.asarray(problem), mesh)
    jst = jsharded(ds, n_true, jlogreg.bundle(), jlr_sampler(),
                   JConfig(fused_grad_step=True, **kw), mesh)(key, st0, ITRS)
    sel, opt = replay_sharded_draws(key, st0, ITRS, jlr_sampler(), n_true, n_data, S, T,
                                    N_SUB, N_SUB)
    job = dict(data=problem, weights=None, model="logreg", cfg=kw, state=_np_state(st0),
               itrs=ITRS, sel=sel, opt=opt)
    ranks = run_world(n_data, 1, {"job": job}, tmp_path)
    assert all(r["jobs"]["job"]["route"] == "fused" for r in ranks)
    for r in ranks:
        _assert_same_build(r["jobs"]["job"]["state"], _np_state(jst))
    assert ranks[0]["jobs"]["job"]["calls"] == {"psum": ITRS * (3 + 2 * T),
                                                "all_gather": ITRS}


def _builders(route, problem, mc_problem, refit_every):
    """(make a builder, initial states) for a route of the single-device
    builder."""
    if route == "fused":
        make = lambda: _logreg_builder(problem, refit_every=refit_every, dedup_select=True)
        st = lambda beta: init_state(M, D, beta=beta, device="cpu")
    else:
        make = lambda: make_incremental_builder(
            torch.from_numpy(mc_problem), multiclass.bundle(K), multiclass_laplace_sampler(K),
            IncrementalConfig(**_kw(refit_every=refit_every, dedup_select=True)))
        st = lambda beta: init_state(M, D_MC + 1, beta=beta, device="cpu",
                                     sampler_aux=torch.zeros(K * D_MC))
    return make, st


@pytest.mark.parametrize("refit_every", [1, 4])
@pytest.mark.parametrize("route", ["fused", "composed"])
def test_buffers_are_refilled_between_builds(problem, mc_problem, route, refit_every):
    """Two builds on one builder, the second from another state (a built
    coreset with another beta) under other draws, each equal a fresh
    builder's result exactly: nothing of an earlier pass is left in the
    buffers."""
    make, st = _builders(route, problem, mc_problem, refit_every)
    one = make()
    first = one.build(st(0.2), 2, one.generator_draws(torch.Generator().manual_seed(1)))
    st_b = first._replace(beta=torch.tensor(0.35))
    second = one.build(st_b, 2, one.generator_draws(torch.Generator().manual_seed(2)))
    again = one.build(st(0.2), 2, one.generator_draws(torch.Generator().manual_seed(1)))
    fresh = make()
    want = fresh.build(st_b, 2, fresh.generator_draws(torch.Generator().manual_seed(2)))
    for got, ref in ((second, want), (again, first)):
        for name, a, b in zip(got._fields, got, ref):
            assert torch.equal(a, b), name
    assert int(second.m) == 4 and not torch.equal(second.wts, first.wts)
    # the results are tensors of their own, not views of the buffers
    p = one._fused if route == "fused" else one._composed
    carry = p.w if route == "fused" else p.x
    assert again.wts.data_ptr() != carry.data_ptr()
    assert again.sampler_aux.data_ptr() not in {t.data_ptr() for t in vars(p).values()
                                                if isinstance(t, torch.Tensor)}


def test_buffers_follow_the_state_shape(problem):
    """A state with another buffer size gets buffers of its own."""
    b = _logreg_builder(problem)
    gen = torch.Generator().manual_seed(0)
    b.build(init_state(M, D, beta=BETA, device="cpu"), 1, b.generator_draws(gen))
    first = b._fused
    b.build(init_state(M, D, beta=BETA, device="cpu"), 1, b.generator_draws(gen))
    assert b._fused is first
    st = b.build(init_state(M + 3, D, beta=BETA, device="cpu"), 1, b.generator_draws(gen))
    assert b._fused is not first and b._fused.M_buf == M + 3 and st.wts.shape == (M + 3,)


def test_graph_argument(problem):
    """None is eager on the CPU; True on a CPU tensor raises; False is
    eager anywhere."""
    Z = torch.from_numpy(problem)
    make = lambda graph: make_incremental_builder(
        Z, logreg.bundle(), logreg_laplace_sampler(), IncrementalConfig(**_kw()), graph=graph)
    assert make(None).graph is False and make(False).graph is False
    with pytest.raises(ValueError, match="CUDA"):
        make(True)
    assert graphs.resolve_graph(None, "cuda") and graphs.resolve_graph(True, "cuda:0")
    assert not graphs.resolve_graph(False, "cuda")
    with pytest.raises(ValueError):
        graphs.resolve_graph(True, "cpu")


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: counts its replays."""

    replays = 0

    def replay(self):
        type(self).replays += 1


@contextlib.contextmanager
def _fake_capture(graph):
    yield


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    monkeypatch.setattr(_FakeGraph, "replays", 0)


def test_replay_adds_the_captured_launches_and_collectives():
    """A replay adds what its graph captured: n launches per counted
    wrapper and the graph's collectives."""
    wrapper = lambda: None
    wrapper.launches = 7
    calls = collections.Counter(psum=5)
    prog = graphs.Captured(_FakeGraph(), [(wrapper, 3)], calls,
                           collections.Counter(psum=2, all_gather=1))
    prog.replay()
    prog.replay()
    assert wrapper.launches == 13
    assert calls == {"psum": 9, "all_gather": 2}


def test_capture_sets_the_counts_back(fake_graphs):
    """Capturing launches nothing: the counts the body advanced while it
    was captured are set back and come with every replay."""
    k1 = kernels.logreg_adam_step
    calls = collections.Counter(all_gather=4)
    before = k1.launches

    def body():
        k1.launches += 2
        calls["psum"] += 3

    prog = graphs.capture(body, calls)
    assert k1.launches == before and calls == {"all_gather": 4}
    assert prog.launches == [(k1, 2)] and prog.captured_calls == {"psum": 3}
    prog.replay()
    assert k1.launches == before + 2 and calls == {"all_gather": 4, "psum": 3}
    k1.launches = before


@pytest.mark.parametrize("k, n_graphs", [(1, 1), (4, 2)])
def test_runner_schedule_and_counts(fake_graphs, k, n_graphs):
    """Ten steps, refitting every k-th (with k > 1 not at step 0), three
    passes: a kind of step runs eagerly the first time it is seen, is
    captured the second time and replayed from then on, one graph per kind;
    the launch count says 10 a pass throughout; ``graph=False`` never
    captures."""
    k3 = kernels.logreg_shard_step_partials
    before, ran = k3.launches, []

    def step(refit):
        ran.append(refit)
        k3.launches += 1

    key = lambda i: k == 1 or (i % k == 0 and i > 0)
    runner = graphs.PassRunner(True)
    for n_pass in range(1, 4):
        runner.run_pass(10, step, key)
        assert k3.launches == before + 10 * n_pass
    assert len(runner.programs) == n_graphs
    assert all(isinstance(p, graphs.Captured) for p in runner.programs.values())
    # the body ran in Python twice per kind of step (eagerly, then while it
    # was captured); every other step of the 30 was a replay
    assert ran == ([True, True] if k == 1 else [False, False, True, True])
    assert _FakeGraph.replays == 30 - n_graphs

    class _Pass:
        pass

    held = _Pass()
    held.runner = runner
    assert graphs.capture_stats((held, None)) == (n_graphs, runner.capture_seconds)
    eager = graphs.PassRunner(False)
    ran.clear()
    eager.run_pass(10, step, key)
    assert ran == [key(i) for i in range(10)] and not eager.programs
    k3.launches = before
