"""The port's object API (betacores_tpu_torch/coresets/api.py and
select_beta.py) against the JAX package's classes, on the CPU
(``device="cpu"``).

- Deterministic: a fixed sampler, select over every row and full-data
  refinement, float64 (the conftest's x64): the port's ``BetaCoreset`` /
  ``SparseVICoreset`` take the same ``build(1, m)`` trajectory as the JAX
  classes, to the tolerance tests/test_coresets.py holds the JAX build to
  the oracle with (rtol 1e-6, atol 1e-9); ``learn_beta`` also against the
  float64 oracle. On this logistic problem the reference-parity select
  keeps its first point (it out-scores every candidate), so the builds
  that should grow use ``dedup_select``.
- Under the JAX draws: the logistic Laplace sampler with subsampled select
  and refinement in float32; the port's object gets the draws of the JAX
  object's own key stream through its one draws method (``_draws``), and
  gives the same selections with weights within 5e-3 max|w|, as the other
  build parity tests.
- The API's own contract, as tests/test_coresets.py states it for JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betacores_tpu as jbc
import betacores_tpu_torch as bc
from betacores_tpu.coresets.api import (uniform_coreset_draws as j_uniform_draws,
                                        weighted_coreset_draws as j_weighted_draws)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference import fixed_sampler as jfixed
from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu.utils.prng import KeySequence as JKeySequence
import importlib
from betacores_tpu_torch.inference import fixed_sampler, logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from oracle import coresets as ocs
from oracle import models as om
from test_torch_incremental import replay_jax_draws

# the packages export the function select_beta, which hides the module
tsel = importlib.import_module("betacores_tpu_torch.coresets.select_beta")
jsel = importlib.import_module("betacores_tpu.coresets.select_beta")
torch.set_num_threads(1)

N, D, S, M, OPT_ITRS = 40, 3, 8, 5, 25


@pytest.fixture(scope="module")
def det():
    """A small logistic problem in float64 with fixed posterior samples."""
    rng = np.random.default_rng(11)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.5 * rng.normal(size=N) > 0, 1.0, -1.0)
    return y[:, None] * X, th + 0.3 * rng.normal(size=(S, D))


def _projectors(samples, use_beta: bool):
    """(JAX projector, port projector) over the fixed samples."""
    jcls, tcls = ((jbc.BetaBlackBoxProjector, bc.BetaBlackBoxProjector) if use_beta
                  else (jbc.BlackBoxProjector, bc.BlackBoxProjector))
    return (jcls(jfixed(jnp.asarray(samples)), S, model=jlogreg.bundle()),
            tcls(fixed_sampler(torch.from_numpy(samples)), S, model=logreg.bundle()))


def _pair(Z, samples, use_beta=True, **kw):
    """The same deterministic coreset in both packages (dedup select
    unless told otherwise)."""
    jprj, tprj = _projectors(samples, use_beta)
    kw = dict(dict(opt_itrs=OPT_ITRS, step_sched=lambda i: 0.5 / (1.0 + i), seed=1,
                   dedup_select=True), **kw)
    if use_beta:
        kw.setdefault("beta", 0.4)
        return (jbc.BetaCoreset(jnp.asarray(Z), jprj, **kw),
                bc.BetaCoreset(Z, tprj, device="cpu", **kw))
    return (jbc.SparseVICoreset(jnp.asarray(Z), jprj, **kw),
            bc.SparseVICoreset(Z, tprj, device="cpu", **kw))


def _same_coreset(got, want, rtol=1e-6, atol=1e-9):
    """Same indices; weights matched by index within the tolerance."""
    (wg, pg, ig), (ww, pw, iw) = got[:3], want[:3]
    np.testing.assert_array_equal(np.sort(ig), np.sort(np.asarray(iw)))
    og, ow = np.argsort(ig), np.argsort(np.asarray(iw))
    np.testing.assert_allclose(wg[og], np.asarray(ww)[ow], rtol=rtol, atol=atol)
    np.testing.assert_allclose(pg[og], np.asarray(pw)[ow], rtol=0, atol=0)


@pytest.mark.parametrize("use_beta", [True, False])
def test_deterministic_build_matches_jax(det, use_beta):
    Z, samples = det
    ja, ta = _pair(Z, samples, use_beta)
    for m in range(1, M + 1):
        ja.build(1, m)
        ta.build(1, m)
        _same_coreset(ta.get(), ja.get())
    assert ta.size() == ja.size() >= 4
    if use_beta:
        assert ta.get()[3] == ja.get()[3] == pytest.approx(0.4)


@pytest.mark.parametrize("dedup", [True, False])
def test_learn_beta_matches_jax_and_oracle(det, dedup):
    """The joint (w, beta) refinement on the deterministic problem: the
    coreset and beta (rel 1e-6) of the JAX class; without dedup (the
    oracle's select) also the float64 oracle's, which takes the analytic
    d/d(beta) written out here. The small steps keep beta off its clamps."""
    Z, samples = det
    sched = lambda i: 0.005 / (1.0 + i)
    ja, ta = _pair(Z, samples, learn_beta=True, step_sched=sched, dedup_select=dedup)
    for m in range(1, M + 1):
        ja.build(1, m)
        ta.build(1, m)
    got, want = ta.get(), ja.get()
    _same_coreset(got, want)
    assert 0.01 < got[3] < 0.39, "beta never moved, or hit a clamp"
    assert got[3] == pytest.approx(want[3], rel=1e-6)
    if dedup:
        assert len(got[0]) >= 4
        return

    def beta_grad(z, th, b):
        m = -(np.atleast_2d(z) @ np.atleast_2d(th).T)
        a, c = np.logaddexp(0.0, m), np.logaddexp(0.0, -m)   # -log p, -log(1-p)
        return (-np.exp(-b * a) / b**2 - (b + 1.0) / b * a * np.exp(-b * a)
                + a * np.exp(-(b + 1.0) * a) + c * np.exp(-(b + 1.0) * c))

    w_o, i_o, _, beta_o = ocs.incremental_build_learn_beta_deterministic(
        Z, M, OPT_ITRS, sched, lambda w, p: samples,
        om.lr_beta_likelihood, beta_grad, 0.4)
    assert got[3] == pytest.approx(beta_o, rel=1e-6)
    keep = w_o > 0
    _same_coreset(got, (w_o[keep], Z[i_o[keep]], i_o[keep]))


@pytest.mark.parametrize("cap", [1.0, 0.45])
def test_learn_beta_respects_the_cap(det, cap):
    """Huge steps push beta against its clamp: it stays in [1e-3, cap],
    as the JAX class's does."""
    Z, samples = det
    ja, ta = _pair(Z, samples, beta=0.4, learn_beta=True, beta_cap=cap,
                   step_sched=lambda i: 5.0)
    ja.build(3, 3)
    ta.build(3, 3)
    beta = ta.get()[3]
    assert 1e-3 <= beta <= cap + 1e-7
    assert beta == pytest.approx(ja.get()[3], rel=1e-6)


# --- under the JAX draws ------------------------------------------------------

NL, DL, SL, N_SEL, N_OPT, T = 1500, 5, 40, 150, 150, 25


@pytest.fixture(scope="module")
def sep():
    """The well-separated float32 problem of test_torch_incremental.py."""
    rng = np.random.default_rng(42)
    th = rng.normal(size=DL)
    X = rng.normal(size=(NL, DL))
    y = np.where(X @ th + 0.3 * rng.normal(size=NL) > 0, 1.0, -1.0)
    return (y[:, None] * X).astype(np.float32)


def _with_jax_draws(alg, seed, smp):
    """Gives the port object ``alg`` the draws of a JAX object of the same
    seed: each build takes the next key of the JAX KeySequence and replays
    that build's draws (the test seam: the one draws method)."""
    keys = JKeySequence(seed)
    cfg = alg._cfg
    jst = jinit_state(alg.state.wts.shape[0], DL, sampler_aux=jnp.zeros(DL, jnp.float32))

    def draws(itrs):
        return replay_jax_draws(keys(), jst, itrs, smp, NL, cfg.projection_dim,
                                cfg.opt_itrs, cfg.n_subsample_select, cfg.n_subsample_opt)

    alg._draws = draws
    return alg


@pytest.mark.parametrize("cls", ["BetaCoreset", "SparseVICoreset"])
def test_build_under_jax_draws_matches_jax(sep, cls):
    kw = dict(n_subsample_select=N_SEL, n_subsample_opt=N_OPT, opt_itrs=T,
              step_sched=lambda i: 0.5 / (1.0 + i), seed=7, max_size=15)
    if cls == "BetaCoreset":
        kw["beta"] = 0.2
        jprj = jbc.BetaBlackBoxProjector(jsampler(), SL, model=jlogreg.bundle())
        tprj = bc.BetaBlackBoxProjector(logreg_laplace_sampler(), SL, model=logreg.bundle())
    else:
        jprj = jbc.BlackBoxProjector(jsampler(), SL, model=jlogreg.bundle())
        tprj = bc.BlackBoxProjector(logreg_laplace_sampler(), SL, model=logreg.bundle())
    ja = getattr(jbc, cls)(jnp.asarray(sep), jprj, **kw)
    ta = _with_jax_draws(getattr(bc, cls)(sep, tprj, device="cpu", **kw), 7, jsampler())
    assert ta._builder.fstep is not None          # K1's plain version
    for m in range(1, 6):
        ja.build(1, m)
        ta.build(1, m)
    jst, tst = ja.state, ta.state
    assert int(tst.m) == int(jst.m) >= 3
    np.testing.assert_array_equal(tst.idcs.numpy(), np.asarray(jst.idcs))
    w0 = np.asarray(jst.wts)
    np.testing.assert_allclose(tst.wts.numpy(), w0, atol=5e-3 * max(1.0, np.abs(w0).max()))


# --- the API's own contract ---------------------------------------------------


def test_build_guard_and_reset(det):
    Z, samples = det
    _, ta = _pair(Z, samples, use_beta=False, opt_itrs=5)
    ta.build(2, 2)
    with pytest.raises(ValueError):
        ta.build(5, 3)                   # itrs + size > sz
    with pytest.raises(ValueError):
        ta.build(1, 0)                   # shrink
    ta.reset()
    assert ta.size() == 0 and int(ta.state.m) == 0


def test_warm_start(det):
    Z, samples = det
    _, tprj = _projectors(samples, False)
    ta = bc.SparseVICoreset(Z, tprj, opt_itrs=5, seed=0, wts=np.ones(3), idcs=np.arange(3),
                            pts=Z[:3], device="cpu")
    assert ta.size() == 3 and ta.initialized == 3
    np.testing.assert_array_equal(ta.state.pts[:3].numpy(), Z[:3])
    ta.build(2, 5)
    assert 3 <= ta.size() <= 5


def test_build_trace_matches_one_shot_build(det):
    """build_trace(5) takes the same draws as build(5, 5), and each
    snapshot is the coreset of that iteration."""
    Z, samples = det
    _, a1 = _pair(Z, samples, use_beta=False, opt_itrs=10, max_size=16)
    _, a2 = _pair(Z, samples, use_beta=False, opt_itrs=10, max_size=16)
    trace = a1.build_trace(5)
    a2.build(5, 5)
    w2, p2, i2 = a2.get()
    wl, pl, il, _ = trace[-1]
    np.testing.assert_allclose(wl, w2, rtol=1e-10)
    np.testing.assert_array_equal(il, i2)
    assert len(trace) == 5
    for m, (wm, pm, im, _) in enumerate(trace, start=1):
        assert 1 <= len(wm) <= m
        np.testing.assert_array_equal(pm, Z[im])


def test_build_trace_keeps_external_warm_points(sep):
    """Warm slots with sentinel indices outside the data report their own
    coordinates in every snapshot; real selections come from the data."""
    rng = np.random.default_rng(0)
    wpts = (rng.normal(size=(3, DL)) + 25.0).astype(np.float32)
    prj = bc.BlackBoxProjector(logreg_laplace_sampler(), 8, model=logreg.bundle())
    alg = bc.SparseVICoreset(sep[:40], prj, opt_itrs=5, seed=1, max_size=10,
                             n_subsample_select=20, n_subsample_opt=12, wts=np.ones(3),
                             idcs=10_000_000 + np.arange(3), pts=wpts, device="cpu")
    trace = alg.build_trace(3)
    assert len(trace) == 3
    for w, p, i, _ in trace:
        for k in range(3):
            sel = i == 10_000_000 + k
            if sel.any():
                np.testing.assert_array_equal(p[sel][0], wpts[k])
        real = (i >= 0) & (i < 40)
        for idx, row in zip(i[real], p[real]):
            np.testing.assert_array_equal(row, sep[int(idx)])


def test_optimize_rolls_back_and_latches(det):
    """error() is a real residual that shrinks as the coreset grows; a
    refinement that raises it is reverted, and latches
    reached_numeric_limit only when it rises by more than
    LATCH_REL_INCREASE; a genuine optimize() is kept. The kept state is the
    object's own tensors, untouched by later passes."""
    Z, samples = det
    _, alg = _pair(Z, samples, use_beta=False, opt_itrs=30)
    e0 = alg.error()
    for m in range(1, 9):
        alg.build(1, m)
    e1 = alg.error()
    assert 0.0 < e1 < 0.8 * e0
    assert alg.error() == e1                 # one projection per build
    good = alg.state
    snap = [t.clone() for t in good]
    builder, error = alg._builder, alg.error

    class Doubling:
        def optimize(self, st, draws, it=0):
            return st._replace(wts=st.wts * 2.0)

        def __getattr__(self, name):
            return getattr(builder, name)

    for rise, latched in ((1.0 + 0.5 * alg.LATCH_REL_INCREASE, False),
                          (1.0 + 2.0 * alg.LATCH_REL_INCREASE, True)):
        costs = iter([1.0, rise])
        alg._builder, alg.error = Doubling(), lambda: next(costs)
        alg.optimize()
        alg._builder, alg.error = builder, error
        assert alg.state is good and alg.reached_numeric_limit == latched
    alg.reached_numeric_limit = False
    alg.optimize()
    assert not alg.reached_numeric_limit and alg.state is not good
    assert alg.error() <= e1 * (1 + 1e-12)
    alg.build(1, 9)
    for a, b in zip(good, snap):
        assert torch.equal(a, b)


@pytest.mark.parametrize("data", [
    [["a", "b"], ["c", "d"]], np.zeros((0, 3)), np.zeros(5), np.ones((2, 2), dtype=bool),
    torch.ones((3, 2), dtype=torch.bool), [[1.0, 2.0], [3.0]]])
def test_garbage_data_raises(det, data):
    _, samples = det
    with pytest.raises(ValueError):
        bc.SparseVICoreset(data, _projectors(samples, False)[1], device="cpu")


def test_entry_points_need_a_card_or_the_cpu(det, monkeypatch):
    """Without CUDA and without device="cpu", every class raises; it never
    carries on on the CPU."""
    Z, samples = det
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prj = _projectors(samples, True)[1]
    for make in (lambda: bc.BetaCoreset(Z, prj), lambda: bc.UniformSamplingCoreset(Z),
                 lambda: tsel.padded_scorer(4, D, lambda w, p: w)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


@pytest.mark.parametrize("what", ["groups", "contextual", "refine", "hilbert", "bpsvi"])
def test_unported_parts_name_their_roadmap_item(det, what):
    Z, samples = det
    prj = _projectors(samples, False)[1]
    item = {"groups": "item 9", "contextual": "item 7", "refine": "item 8",
            "hilbert": "item 8", "bpsvi": "item 9"}[what]
    with pytest.raises(NotImplementedError, match=item):
        if what == "groups":
            bc.SparseVICoreset(Z, prj, groups=[[0, 1], [2]], device="cpu")
        elif what == "contextual":
            bc.coresets.ContextualProjector(None, S, None)
        elif what == "refine":
            bc.SparseVICoreset(Z, prj, device="cpu").refine()
        elif what == "hilbert":
            bc.HilbertCoreset(Z, prj, device="cpu")
        else:
            bc.BatchPSVICoreset(Z, prj, device="cpu")


# --- UniformSamplingCoreset ---------------------------------------------------


def _feed_jax_stream(alg, seed, weights=None):
    """The port's uniform coreset drawing the JAX class's index stream."""
    key = jax.random.key(seed)
    n0 = [0]
    if weights is None:
        def draw(itrs):
            out = np.asarray(j_uniform_draws(key, itrs, alg.data.shape[0], n0[0]))
            n0[0] += itrs
            return out
    else:
        pos = np.flatnonzero(weights > 0)
        cdf = np.cumsum(weights[pos])
        cdf = jnp.asarray(cdf / cdf[-1])

        def draw(itrs):
            j = np.asarray(j_weighted_draws(key, itrs, start=n0[0], cdf=cdf))
            n0[0] += itrs
            return pos[j]
    alg._draw_points = draw
    return alg


@pytest.mark.parametrize("weighted", [False, True])
def test_uniform_counts_and_weights_match_jax(det, weighted):
    Z, _ = det
    u = None
    if weighted:
        u = np.random.default_rng(2).uniform(0.5, 3.0, size=N)
        u[::4] = 0.0
    ja = jbc.UniformSamplingCoreset(jnp.asarray(Z), seed=3, data_weights=u)
    ta = _feed_jax_stream(bc.UniformSamplingCoreset(Z, seed=3, data_weights=u, device="cpu"),
                          3, u)
    for m in range(1, 13):
        ja.build(1, m)
        ta.build(1, m)
        assert ta.cts == ja.cts
        wg, pg, ig = ta.get()
        ww, pw, iw = ja.get()
        np.testing.assert_array_equal(ig, np.asarray(iw))
        np.testing.assert_allclose(wg, np.asarray(ww), rtol=1e-12)
        np.testing.assert_array_equal(pg, np.asarray(pw))


def test_uniform_own_stream_trace_equals_build_loop_and_skips_zero_mass(det):
    """The host generator's stream: build_trace and a build(1, m) loop give
    the same snapshots, reset rewinds it, and rows of zero weight are
    never drawn."""
    Z, _ = det
    u = np.ones(N)
    u[N // 2:] = 0.0
    a1 = bc.UniformSamplingCoreset(Z, seed=4, data_weights=u, device="cpu")
    a2 = bc.UniformSamplingCoreset(Z, seed=4, data_weights=u, device="cpu")
    trace = a1.build_trace(30)
    for m, (wt, pt, it) in enumerate(trace, start=1):
        a2.build(1, m)
        w2, p2, i2 = a2.get()
        assert {int(i): float(w) for i, w in zip(it, wt)} == pytest.approx(
            {int(i): float(w) for i, w in zip(i2, w2)})
        np.testing.assert_array_equal(pt[np.argsort(it)], p2[np.argsort(i2)])
    assert (trace[-1][2] < N // 2).all()
    assert trace[-1][0].sum() == pytest.approx(u.sum())
    first = sorted(a2.cts)
    a2.reset()
    a2.build(30, 30)
    assert sorted(a2.cts) == first


def test_uniform_keeps_warm_prefix(det):
    """The constructor warm start is a count-1 prefix with its own
    coordinates (sentinel indices), in get() and in every build_trace
    snapshot, as a build(1, m) loop reports it."""
    Z, _ = det
    wpts = np.random.default_rng(5).normal(size=(2, D)) + 9.0
    mk = lambda: bc.UniformSamplingCoreset(Z, seed=4, wts=np.ones(2),
                                           idcs=10_000_000 + np.arange(2), pts=wpts,
                                           device="cpu")
    a1, a2 = mk(), mk()
    trace = a1.build_trace(4)
    for m, (wt, pt, it) in enumerate(trace, start=1):
        a2.build(1, m + 2)
        w2, p2, i2 = a2.get()
        assert {int(i): float(w) for i, w in zip(it, wt)} == pytest.approx(
            {int(i): float(w) for i, w in zip(i2, w2)})
        assert {10_000_000, 10_000_001} <= set(it.tolist())
        for k in range(2):
            np.testing.assert_array_equal(pt[it == 10_000_000 + k][0], wpts[k])
            np.testing.assert_array_equal(p2[i2 == 10_000_000 + k][0], wpts[k])


# --- select_beta --------------------------------------------------------------


def test_trimmed_mean_select_beta_and_padded_scorer_match_jax():
    rng = np.random.default_rng(6)
    x = np.r_[rng.normal(size=37), [-100.0, -50.0, -70.0]]
    for trim in (0.0, 0.2, 0.9):
        assert float(tsel.trimmed_mean(torch.from_numpy(x), trim)) == pytest.approx(
            float(jsel.trimmed_mean(jnp.asarray(x), trim)), rel=1e-12)
    betas = [0.1, 0.3, 0.5]
    table = {0.1: x, 0.3: x + 0.5, 0.5: np.r_[x[:-1], np.nan]}
    build = lambda b: (np.ones(1) * b, np.zeros((1, 2)))
    got = tsel.select_beta(build, betas, lambda w, p: torch.from_numpy(table[float(w[0])]))
    want = jsel.select_beta(build, betas, lambda w, p: jnp.asarray(table[float(w[0])]))
    assert got[0] == want[0] == 0.3
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    with pytest.raises(ValueError):
        tsel.select_beta(build, [0.5], lambda w, p: torch.from_numpy(table[0.5]) * np.inf)
    seen = {}
    score = tsel.padded_scorer(4, 2, lambda w, p: seen.setdefault("wp", (w, p)) and w,
                               device="cpu")
    score(np.array([1.0, 2.0]), np.ones((2, 2)))
    w, p = seen["wp"]
    assert w.tolist() == [1.0, 2.0, 0.0, 0.0] and p.shape == (4, 2) and w.dtype == torch.float32


def test_driver_select_beta_picks_the_jax_beta(det):
    """The driver block over the port's BetaCoreset picks the beta the JAX
    driver picks on the deterministic problem (each build reset and rebuilt
    at its beta). The score of a build is the held-out rows' predictive
    log-likelihood under the fixed samples less the build's total weight,
    so it depends on the build through its weights."""
    Z, samples = det
    Zho, Zb = Z[-10:], Z[:-10]
    ja, ta = _pair(Zb, samples)
    grid = [0.05, 0.3, 0.8]
    ll = np.asarray(jlogreg.log_likelihood(jnp.asarray(Zho), jnp.asarray(samples)))
    pll = np.log(np.mean(np.exp(ll), axis=1))
    sj = lambda w, p: jnp.asarray(pll) - jnp.sum(jnp.asarray(w))
    st = lambda w, p: torch.from_numpy(pll) - float(np.sum(w))
    bj, rj, _ = jsel.driver_select_beta(ja, grid, sj, 0.2, 3)
    bt, rt, cache = tsel.driver_select_beta(ta, grid, st, 0.2, 3)
    assert bt == bj and set(cache) == set(grid)
    np.testing.assert_allclose(rt["scores"], rj["scores"], rtol=1e-6)
