"""Whole builds of the port's model families against the JAX builds under
the JAX builds' own draws, on the CPU in float64: the known-covariance
Gaussian through the object API (``BetaCoreset``, ``SparseVICoreset`` and
``learn_beta``), Poisson regression with lagged refits, linear regression,
and the unknown-covariance Gaussian through a fixed sampler fed the JAX NIW
sampler's draws. The JAX draws are rebuilt from its keys by
``replay_jax_draws`` (tests/test_torch_incremental.py) and replayed through
``FixedDraws`` (or the API object's ``_draws``). Each build must select
the same ``idcs`` and land within 5e-3 max(1, max|w|) of the JAX weights,
the bar of the earlier slices.

The NIW sampler has no noise split, so the port runs it on its
per-step-draw route, whose draws no JAX stream can match: that route is
held against itself (the same generator seed gives the same build), and
against the pre-drawn composed route on a deterministic sampler without a
noise split, fed the same subsample indices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betacores_tpu as jbc
import betacores_tpu_torch as bc
from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference.samplers import (fixed_sampler as jfixed,
                                              gaussian_conjugate_sampler as jgauss_sampler,
                                              linreg_conjugate_sampler as jlinreg_sampler,
                                              poisson_laplace_sampler as jpoisson_sampler)
from betacores_tpu.models import gaussian as jg
from betacores_tpu.models import linreg as jl
from betacores_tpu.models import mvn as jm
from betacores_tpu.models import poisson as jp
from betacores_tpu.utils.prng import KeySequence as JKeySequence
from betacores_tpu_torch.coresets import (FixedDraws, IncrementalConfig,
                                         make_incremental_builder, state_from_numpy,
                                         state_to_numpy)
from betacores_tpu_torch.inference import (fixed_sampler, gaussian_conjugate_sampler,
                                           linreg_conjugate_sampler, poisson_laplace_sampler)
from betacores_tpu_torch.models import gaussian as tg
from betacores_tpu_torch.models import linreg as tl
from betacores_tpu_torch.models import mvn as tm
from betacores_tpu_torch.models import poisson as tp
from test_torch_incremental import _assert_same_build, _np_state, replay_jax_draws

torch.set_num_threads(1)

S, N_SEL, N_OPT, T, ITRS, M = 32, 128, 64, 30, 6, 16


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def gauss():
    """A contaminated Gaussian: 600 clean rows and 60 shifted by 8."""
    rng = np.random.default_rng(11)
    d = 4
    Sig = 3.0 * np.eye(d)
    X = np.vstack([rng.multivariate_normal(np.zeros(d), Sig, 600),
                   rng.normal(size=(60, d)) + 8.0])
    Siginv = np.linalg.inv(Sig)
    prior = (np.zeros(d), np.eye(d), Siginv)
    return dict(X=X, d=d, Siginv=Siginv, logdet=float(np.linalg.slogdet(Sig)[1]),
                prior=prior)


def _with_jax_draws(alg, seed, smp, n_rows, dim, theta_dim):
    """Gives the port object ``alg`` the draws of a JAX object of the same
    seed: each build takes the next key of the JAX KeySequence and replays
    that build's draws (the object's one draws method)."""
    keys, cfg = JKeySequence(seed), alg._cfg
    jst = jinit_state(alg.state.wts.shape[0], dim, sampler_aux=jnp.zeros(theta_dim),
                      dtype=jnp.float64)
    alg._draws = lambda itrs: replay_jax_draws(
        keys(), jst, itrs, smp, n_rows, cfg.projection_dim, cfg.opt_itrs,
        cfg.n_subsample_select, cfg.n_subsample_opt)
    return alg


@pytest.mark.parametrize("cls, learn_beta", [("BetaCoreset", False), ("SparseVICoreset", False),
                                             ("BetaCoreset", True)])
def test_gaussian_api_build_matches_jax(gauss, cls, learn_beta):
    """The object API over the Gaussian bundle and the conjugate sampler,
    ``build(1, m)`` six times, against the JAX class under its draws; with
    ``learn_beta`` beta too (rel 1e-6), moved off its start."""
    g = gauss
    jmodel, tmodel = jg.bundle(jnp.asarray(g["Siginv"]), g["logdet"]), tg.bundle(
        t(g["Siginv"]), g["logdet"])
    jsmp = jgauss_sampler(*map(jnp.asarray, g["prior"]))
    tsmp = gaussian_conjugate_sampler(*map(t, g["prior"]))
    kw = dict(n_subsample_select=N_SEL, n_subsample_opt=N_OPT, opt_itrs=T,
              step_sched=lambda i: (0.02 if learn_beta else 1.0) / (1.0 + i), seed=7,
              max_size=M)
    if cls == "BetaCoreset":
        kw.update(beta=0.3, learn_beta=learn_beta)
        jprj = jbc.BetaBlackBoxProjector(jsmp, S, model=jmodel)
        tprj = bc.BetaBlackBoxProjector(tsmp, S, model=tmodel)
    else:
        jprj = jbc.BlackBoxProjector(jsmp, S, model=jmodel)
        tprj = bc.BlackBoxProjector(tsmp, S, model=tmodel)
    ja = getattr(jbc, cls)(jnp.asarray(g["X"]), jprj, **kw)
    ta = _with_jax_draws(getattr(bc, cls)(g["X"], tprj, device="cpu", **kw), 7, jsmp,
                         len(g["X"]), g["d"], g["d"])
    assert ta._builder.fstep is None and not ta._builder.per_step
    for m in range(1, ITRS + 1):
        ja.build(1, m)
        ta.build(1, m)
    _assert_same_build(state_to_numpy(ta.state), _np_state(ja.state))
    if learn_beta:
        beta = float(ja.state.beta)
        assert beta != 0.3
        np.testing.assert_allclose(float(ta.state.beta), beta, rtol=1e-6)


def _functional(X, jmodel, jsmp, tmodel, tsmp, d, theta_dim, key, **change):
    """(port state, JAX state) of ITRS selections of the functional
    builders over X from the empty state, the port under the JAX draws."""
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=1.0, use_beta=True)
    kw.update(change)
    st0 = jinit_state(M, d, beta=0.3, sampler_aux=jnp.zeros(theta_dim), dtype=jnp.float64)
    jst = jbuilder(jnp.asarray(X), jmodel, jsmp, JConfig(**kw)).build(key, st0, ITRS)
    tb = make_incremental_builder(t(X), tmodel, tsmp, IncrementalConfig(**kw))
    draws = replay_jax_draws(key, st0, ITRS, jsmp, len(X), S, T, N_SEL, N_OPT)
    tst = tb.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS, draws)
    return state_to_numpy(tst), _np_state(jst)


@pytest.mark.parametrize("gaussian_mass", [False, True])
def test_poisson_build_with_lagged_refits_matches_jax(gaussian_mass):
    """Poisson regression with 10 % of the counts shifted by +50, the
    Laplace sampler refitting every 4th step, against the JAX build."""
    rng = np.random.default_rng(2)
    n, d = 800, 4
    X = np.c_[rng.normal(size=(n, d - 1)), np.ones(n)]
    y = rng.poisson(np.logaddexp(0.0, X @ (0.5 * rng.normal(size=d)))).astype(float)
    y[rng.choice(n, n // 10, replace=False)] += 50.0
    Z = np.c_[X, y]
    got, want = _functional(Z, jp.bundle(k_max=96, gaussian_mass=gaussian_mass),
                            jpoisson_sampler(), tp.bundle(k_max=96, gaussian_mass=gaussian_mass),
                            poisson_laplace_sampler(), d + 1, d, jax.random.PRNGKey(5),
                            refit_every=4, dedup_select=True)
    _assert_same_build(got, want)


def test_linreg_build_matches_jax():
    rng = np.random.default_rng(4)
    n, d = 700, 5
    X = np.c_[rng.normal(size=(n, d - 1)), np.ones(n)]
    y = X @ (10.0 + rng.normal(size=d)) + 0.5 * rng.normal(size=n)
    y[:70] += 30.0
    Z = np.c_[X, y]
    sigsq = float(np.var(y))
    prior = (np.mean(y) * np.ones(d), np.eye(d) / (np.var(y) + np.mean(y) ** 2))
    got, want = _functional(Z, jl.bundle(sigsq), jlinreg_sampler(*map(jnp.asarray, prior), sigsq),
                            tl.bundle(sigsq), linreg_conjugate_sampler(*map(t, prior), sigsq),
                            d + 1, d, jax.random.PRNGKey(6), dedup_select=True)
    _assert_same_build(got, want)


class _ZeroNoise:
    """Stands in for a sampler's ``draw_noise`` when rebuilding the draws
    of a JAX build with a fixed sampler: only the subsample keys matter."""

    def __init__(self, theta_dim):
        self.theta_dim = theta_dim

    def draw_noise(self, key, n, wts, pts, aux):
        return jnp.zeros((n, self.theta_dim))


@pytest.fixture(scope="module")
def mvn_problem():
    rng = np.random.default_rng(3)
    d = 3
    X = np.vstack([rng.normal(size=(600, d)) + 2.0, rng.normal(size=(60, d)) * 0.5 + 12.0])
    prior = (np.zeros(d), 1.0, 2.0 * np.eye(d), d + 4.0)
    return X, d, prior


def test_mvn_build_under_jax_niw_draws_matches_jax(mvn_problem):
    """The MVN family through a fixed sampler fed S draws of the JAX NIW
    sampler (of the clean rows' posterior) on both sides: the same
    selections and weights as the JAX build under its subsample draws."""
    X, d, prior = mvn_problem
    td = d + d * d
    jsmp = jm.mvn_niw_sampler(*(jnp.asarray(v) for v in prior))
    samples, _ = jsmp(jax.random.PRNGKey(8), S, jnp.ones(600), jnp.asarray(X[:600]),
                      jnp.zeros(td))
    key = jax.random.PRNGKey(9)
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=1.0, use_beta=True, dedup_select=True)
    st0 = jinit_state(M, d, beta=0.5, sampler_aux=jnp.zeros(td), dtype=jnp.float64)
    jst = jbuilder(jnp.asarray(X), jm.bundle(d), jfixed(samples), JConfig(**kw)).build(
        key, st0, ITRS)
    tb = make_incremental_builder(t(X), tm.bundle(d), fixed_sampler(t(np.asarray(samples))),
                                  IncrementalConfig(**kw))
    draws = replay_jax_draws(key, st0, ITRS, _ZeroNoise(td), len(X), S, T, N_SEL, N_OPT)
    tst = tb.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS, draws)
    _assert_same_build(state_to_numpy(tst), _np_state(jst))


def _niw_builder(X, d, prior, **change):
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=1.0, use_beta=True, dedup_select=True)
    kw.update(change)
    smp = tm.mvn_niw_sampler(*(t(np.asarray(v)) for v in prior))
    return make_incremental_builder(t(X), tm.bundle(d), smp, IncrementalConfig(**kw))


@pytest.mark.parametrize("change", [dict(), dict(learn_beta=True, i0=0.05),
                                    dict(n_subsample_opt=None)])
def test_niw_per_step_route_is_its_own_seeded_stream(mvn_problem, change):
    """The per-step-draw route (subsampled, learn_beta, full-data): two
    builds from one generator seed are bit-identical, another seed gives
    another build, and the draws' generator is advanced past the pass."""
    X, d, prior = mvn_problem
    b = _niw_builder(X, d, prior, **change)
    assert b.per_step
    st0 = bc.init_state(M, d, beta=0.5, sampler_aux=torch.zeros(d + d * d, dtype=torch.float64),
                        dtype=torch.float64, device="cpu")
    gens = [torch.Generator().manual_seed(s) for s in (1, 1, 2)]
    out = [b.build(st0, 3, b.generator_draws(g)) for g in gens]
    for u, v in zip(out[0], out[1]):
        assert torch.equal(u, v)
    assert not torch.equal(out[0].wts, out[2].wts)
    assert int(out[0].m) >= 2 and bool(torch.isfinite(out[0].wts).all())
    assert not torch.equal(gens[0].get_state(), torch.Generator().manual_seed(1).get_state())
    with pytest.raises(ValueError, match="GeneratorDraws"):
        b.build(st0, 1, FixedDraws([], []))


class _CallOnly:
    """A deterministic sampler without a noise split: the per-step-draw
    route's stand-in for the NIW sampler, drawing nothing itself."""

    def __init__(self, samples):
        self.samples = samples

    def __call__(self, generator, n, wts, pts, aux):
        return self.samples[:n], aux


def test_per_step_route_equals_the_pre_drawn_route(mvn_problem):
    """On a sampler that draws nothing, the per-step-draw route's only
    draws are its subsamples, one per select and one per step, in that
    order from the generator: fed the same indices, the pre-drawn composed
    route (a fixed sampler with a noise split) builds the same coreset."""
    X, d, prior = mvn_problem
    td = d + d * d
    samples = tm.sample_niw(torch.Generator().manual_seed(5),
                            tm.mvn_niw_sampler(*(t(np.asarray(v)) for v in prior)).posterior(
                                torch.ones(600, dtype=torch.float64), t(X[:600])), S)
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=1.0, use_beta=True, dedup_select=True)
    st0 = bc.init_state(M, d, beta=0.5, sampler_aux=torch.zeros(td, dtype=torch.float64),
                        dtype=torch.float64, device="cpu")
    per_step = make_incremental_builder(t(X), tm.bundle(d), _CallOnly(samples),
                                        IncrementalConfig(**kw))
    assert per_step.per_step
    got = per_step.build(st0, 4, per_step.generator_draws(torch.Generator().manual_seed(3)))
    gen = torch.Generator().manual_seed(3)
    zeros = torch.zeros(S, td, dtype=torch.float64)
    sel, opt = [], []
    for _ in range(4):
        sel.append((zeros, torch.randint(0, len(X), (N_SEL,), generator=gen)))
        opt.append((zeros.expand(T, S, td),
                    torch.stack([torch.randint(0, len(X), (N_OPT,), generator=gen)
                                 for _ in range(T)])))
    pre = make_incremental_builder(t(X), tm.bundle(d), fixed_sampler(samples),
                                   IncrementalConfig(**kw))
    want = pre.build(st0, 4, FixedDraws(sel, opt))
    assert torch.equal(got.idcs, want.idcs) and int(got.m) == int(want.m) == 4
    torch.testing.assert_close(got.wts, want.wts, rtol=1e-12, atol=1e-12)


def test_niw_api_build_error_and_sharded_refusal(mvn_problem):
    """The NIW family through the object API (theta_dim d + d*d reaches the
    warm start): the robust coreset's posterior mean lands closer to the
    clean one than the corrupted full-data fit's, as tests/test_mvn.py
    asks of the JAX build; ``error()`` and ``optimize()`` run (the error's
    generator is made anew from one seed per build, so repeated calls
    agree); lagged refits raise, and the sharded build without a mesh."""
    X, d, prior = mvn_problem
    tprior = tuple(t(np.asarray(v)) for v in prior)
    smp = tm.mvn_niw_sampler(*tprior)
    prj = bc.BetaBlackBoxProjector(smp, S, model=tm.bundle(d), theta_dim=d + d * d)
    alg = bc.BetaCoreset(X, prj, beta=0.5, opt_itrs=60, n_subsample_select=400,
                         n_subsample_opt=200, max_size=30, seed=3, device="cpu")
    assert alg.state.sampler_aux.shape == (d + d * d,)
    alg.build(12, 12)
    w, p, _, _ = alg.get()
    post = lambda pts, wts: tm.weighted_post(*tprior, t(pts), t(wts))
    clean, bad, core = post(X[:600], np.ones(600)), post(X, np.ones(len(X))), post(p, w)
    err_core = float(torch.linalg.norm(core.mu - clean.mu))
    err_bad = float(torch.linalg.norm(bad.mu - clean.mu))
    assert err_core < 0.5 * err_bad, (err_core, err_bad)
    e1, e2 = alg.error(), alg.error()
    assert e1 == e2 and np.isfinite(e1)
    alg.optimize()
    assert np.isfinite(alg.error())
    with pytest.raises(NotImplementedError, match="refit_every"):
        bc.BetaCoreset(X, prj, beta=0.5, refit_every=4, n_subsample_opt=50, device="cpu")
    # the sharded NIW build is ported (tests/test_torch_sharded.py): it
    # refuses only a missing mesh, as the JAX builder's require_axes does
    with pytest.raises(ValueError, match="mesh must have axes"):
        bc.make_sharded_incremental_builder(t(X), len(X), tm.bundle(d), smp,
                                            IncrementalConfig(projection_dim=S), mesh=None)


def test_capture_registers_the_steps_generators(monkeypatch):
    """The per-step-draw pass names its generator to its runner, and a
    capture registers it with the graph before capturing (a stand-in for
    torch.cuda.CUDAGraph records the order)."""
    import contextlib

    from betacores_tpu_torch.utils import graphs

    events = []

    class Graph:
        def register_generator_state(self, gen):
            events.append(("register", gen))

        def replay(self):
            events.append(("replay",))

    @contextlib.contextmanager
    def capturing(graph):
        events.append(("capture",))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capturing)
    gen = torch.Generator()
    runner = graphs.PassRunner(True)
    runner.generators = (gen,)
    for _ in range(3):
        runner.run("step", lambda: None)
    assert events == [("register", gen), ("capture",), ("replay",), ("replay",)]


def test_theta_dim_reaches_the_warm_start():
    """The projectors' ``theta_dim`` sizes the sampler's warm start: D - 1
    for Poisson's [x, y] rows, d + d*d for the NIW family; a warm-started
    coreset and a buffer growth keep it."""
    rng = np.random.default_rng(0)
    Z = np.c_[rng.normal(size=(50, 3)), np.ones(50), rng.poisson(2.0, size=50)]
    prj = bc.BetaBlackBoxProjector(poisson_laplace_sampler(), 8, theta_dim=4,
                                   model=tp.bundle())
    alg = bc.BetaCoreset(Z, prj, opt_itrs=3, max_size=4, device="cpu")
    assert alg.state.sampler_aux.shape == (4,)
    alg.build(2, 2)
    assert alg.state.sampler_aux.shape == (4,) and alg.state.pts.shape[1] == 5
    warm = bc.BetaCoreset(Z, prj, opt_itrs=3, wts=np.ones(2), idcs=np.arange(2), pts=Z[:2],
                          device="cpu")
    assert warm.state.sampler_aux.shape == (4,)
    warm.build(70, 72)                                  # grows the buffer past 64 slots
    assert warm.state.wts.shape[0] == 128 and warm.state.sampler_aux.shape == (4,)


def test_niw_build_with_data_reads_the_given_rows(mvn_problem):
    """``build_with_data`` on the per-step-draw route: the pass gathers its
    rows from the data it is given (not the rows its first pass read), so
    it equals a builder made over that data, from the same seed."""
    X, d, prior = mvn_problem
    X2 = X[::-1].copy()
    b, fresh = _niw_builder(X, d, prior), _niw_builder(X2, d, prior)
    st0 = bc.init_state(M, d, beta=0.5, sampler_aux=torch.zeros(d + d * d, dtype=torch.float64),
                        dtype=torch.float64, device="cpu")
    b.build(st0, 1, b.generator_draws(torch.Generator().manual_seed(4)))
    got = b.build_with_data(t(X2), None, st0, 2, b.generator_draws(torch.Generator().manual_seed(4)))
    want = fresh.build(st0, 2, fresh.generator_draws(torch.Generator().manual_seed(4)))
    for u, v in zip(got, want):
        assert torch.equal(u, v)
