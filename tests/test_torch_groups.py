"""The port's group (batch) selection (betacores_tpu_torch/ops/projection.py
``Groups``, coresets/groups.py and the group mode of coresets/api.py)
against the JAX package, on the CPU.

- Deterministic builds (a fixed sampler, every group scored, every row in
  the refinement target, float64) against the NumPy oracle's group golden
  (oracle/coresets.py:218): the same selected groups and indices, weights
  within rtol 1e-6, atol 1e-9 (the JAX package's own golden tolerance).
- Builds under the JAX build's own draws (the logistic Laplace sampler),
  replayed into the port (test_torch_incremental.py's recipe, with select's
  candidates drawn over the groups): the same selected groups, m and
  indices, weights within 5e-3 * max(1, max|w|). The full-data builds run
  in float32. The subsampled ones run in float64: there the refinement's
  Adam amplifies float32 rounding from selection to selection (on this
  problem 5e-7 after one selection and 0.34 of max|w| = 7.5 after five,
  in the JAX build as in the port, while in float64 the two stay within
  1e-8), so float32 would test the rounding, not the port.
- The object API's group mode and ``UniformSamplingCoreset(groups=)`` fed
  the JAX objects' draw streams, and the refusals.
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
from betacores_tpu.coresets.groups import (group_ids_from_groups as j_gids,
                                           init_group_state as j_init_gst,
                                           make_group_incremental_builder as j_builder)
from betacores_tpu.coresets.incremental import IncrementalConfig as JConfig
from betacores_tpu.coresets.state import init_state as j_init_state
from betacores_tpu.coresets.state import warm_start_state as j_warm_state
from betacores_tpu.inference import fixed_sampler as j_fixed
from betacores_tpu.inference.samplers import logreg_laplace_sampler as j_laplace
from betacores_tpu.models import gaussian as j_gauss
from betacores_tpu.models import logreg as j_logreg
from betacores_tpu.ops.projection import Groups as JGroups
from betacores_tpu.ops.projection import project_groups as j_project_groups
from betacores_tpu.ops.projection import project_ll as j_project_ll
from betacores_tpu.utils.prng import KeySequence as JKeySequence
from betacores_tpu_torch.coresets import (FixedDraws, IncrementalConfig, init_state,
                                         state_to_numpy)
from betacores_tpu_torch.coresets import groups as groups_mod
from betacores_tpu_torch.coresets.groups import (group_ids_from_groups, init_group_state,
                                                 make_group_incremental_builder)
from betacores_tpu_torch.coresets.state import group_state_from_numpy
from betacores_tpu_torch.inference import fixed_sampler, logreg_laplace_sampler
from betacores_tpu_torch.models import gaussian, logreg
from betacores_tpu_torch.ops.projection import Groups, project_groups, project_ll
from oracle import coresets as ocs
from oracle import models as om
from test_torch_incremental import replay_jax_draws

torch.set_num_threads(1)

# the deterministic problem of tests/test_groups.py
GN, GD, GS = 60, 3, 8
SIZES = [5, 12, 3, 20, 10, 10]
# the logistic problem: 40 groups of 5..39 rows
LN, LD, LS, LT, ITRS = 1200, 5, 40, 20, 5


def _contiguous(sizes):
    groups, i = [], 0
    for s in sizes:
        groups.append(list(range(i, i + int(s))))
        i += int(s)
    return groups


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(42)
    X = rng.normal(size=(GN, GD))
    samples = rng.normal(size=(GS, GD))
    Siginv = np.linalg.inv(2.0 * np.eye(GD))
    logdet = float(np.linalg.slogdet(2.0 * np.eye(GD))[1])
    return X, samples, Siginv, logdet, _contiguous(SIZES)


@pytest.fixture(scope="module")
def logistic():
    rng = np.random.default_rng(42)
    th = rng.normal(size=LD)
    X = rng.normal(size=(LN, LD))
    y = np.where(X @ th + 0.3 * rng.normal(size=LN) > 0, 1.0, -1.0)
    groups = _contiguous(rng.integers(5, 40, size=40))
    return y[:, None] * X, groups


def _np(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _np_gst(gst):
    return {"core": _np(gst.core), "selected": np.asarray(gst.selected),
            "initialized": np.asarray(gst.initialized)}


def _assert_same_group_build(got, want, tol=5e-3):
    """Same selected groups, m, indices and rows; weights within
    tol * max(1, max|w|); padding slots at weight 0 and index -1."""
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(want.selected))
    m = int(want.core.m)
    assert int(got.core.m) == m > 0
    np.testing.assert_array_equal(got.core.idcs.numpy(), np.asarray(want.core.idcs))
    np.testing.assert_array_equal(got.core.pts.numpy(), np.asarray(want.core.pts))
    w0 = np.asarray(want.core.wts)
    np.testing.assert_allclose(got.core.wts.numpy(), w0, rtol=0,
                               atol=tol * max(1.0, np.abs(w0).max()))
    assert (got.core.wts.numpy()[m:] == 0).all() and (got.core.idcs.numpy()[m:] == -1).all()


# --- Groups and the group reduction ------------------------------------------------


def test_group_projection_matches_member_sums(gauss):
    """project_groups and both group reductions of the builder equal the
    members' sums and the JAX package's project_groups."""
    X, samples, Siginv, logdet, groups = gauss
    gp = Groups.from_lists(groups, device="cpu")
    assert (gp.n_groups, gp.max_size) == (len(groups), max(SIZES))
    model = gaussian.bundle(torch.from_numpy(Siginv), logdet)
    proj = lambda pts: project_ll(model, pts, torch.from_numpy(samples))
    got = project_groups(proj, torch.from_numpy(X), gp).numpy()
    full = proj(torch.from_numpy(X)).numpy()
    jmodel = j_gauss.bundle(jnp.asarray(Siginv), logdet)
    want = np.asarray(j_project_groups(lambda p: j_project_ll(jmodel, p, jnp.asarray(samples)),
                                       jnp.asarray(X), JGroups.from_lists(groups)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    for g, mem in enumerate(groups):
        np.testing.assert_allclose(got[g], full[mem].sum(axis=0), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(group_ids_from_groups(gp, GN).numpy(),
                                  np.asarray(j_gids(JGroups.from_lists(groups), GN)))
    cfg = IncrementalConfig(projection_dim=GS, opt_itrs=2)
    onehot = make_group_incremental_builder(torch.from_numpy(X), gp, model,
                                            fixed_sampler(torch.from_numpy(samples)), cfg)
    assert onehot.onehot is not None
    np.testing.assert_allclose(onehot.group_reduce(torch.from_numpy(full)).numpy(), got,
                               rtol=1e-12, atol=1e-12)
    sub = project_groups(proj, torch.from_numpy(X), gp, torch.tensor([4, 1])).numpy()
    np.testing.assert_allclose(sub, got[[4, 1]], rtol=1e-12)


def test_groups_must_be_disjoint_and_padding_is_minus_one():
    gp = Groups.from_lists([[0, 1, 2], [5]], device="cpu")
    np.testing.assert_array_equal(gp.members.numpy(), [[0, 1, 2], [5, -1, -1]])
    np.testing.assert_array_equal(gp.sizes.numpy(), [3, 1])
    # row 3 and 4 are in no group: id G
    np.testing.assert_array_equal(group_ids_from_groups(gp, 6).numpy(), [0, 0, 0, 2, 2, 1])
    with pytest.raises(ValueError, match="disjoint"):
        Groups.from_lists([[0, 1], [1, 2]], device="cpu")


# --- deterministic builds against the oracle -----------------------------------------


def _deterministic_port(X, samples, Siginv, logdet, groups, cfg, itrs, M=60, gate=None,
                        monkeypatch=None):
    if gate is not None:
        monkeypatch.setattr(groups_mod, "ONEHOT_MAX_BYTES", gate)
    builder = make_group_incremental_builder(
        torch.from_numpy(X), Groups.from_lists(groups, device="cpu"),
        gaussian.bundle(torch.from_numpy(Siginv), logdet),
        fixed_sampler(torch.from_numpy(samples)), cfg)
    zeros = torch.zeros((GS, GD), dtype=torch.float64)
    T = cfg.opt_itrs
    draws = FixedDraws([(zeros, None)] * itrs, [(zeros.expand(T, -1, -1), None)] * itrs)
    gst = init_group_state(init_state(M, GD, dtype=torch.float64, device="cpu"), len(groups))
    return builder, builder.build(gst, itrs, draws), draws


@pytest.mark.parametrize("dedup", [False, True])
def test_group_build_matches_oracle(gauss, dedup):
    """oracle/coresets.py:218 (group_incremental_build_deterministic)."""
    X, samples, Siginv, logdet, groups = gauss
    itrs, opt_itrs, i0 = 4, 20, 0.5
    cfg = IncrementalConfig(projection_dim=GS, opt_itrs=opt_itrs, i0=i0, dedup_select=dedup)
    _, gst, _ = _deterministic_port(X, samples, Siginv, logdet, groups, cfg, itrs)
    w_o, i_o, p_o, sel_o = ocs.group_incremental_build_deterministic(
        X, groups, itrs, opt_itrs, lambda i: i0 / (1.0 + i), lambda w, p: samples,
        lambda pts, s: om.gauss_log_likelihood(pts, s, Siginv, logdet), dedup=dedup)
    np.testing.assert_array_equal(gst.selected.numpy(), sel_o)
    m = int(gst.core.m)
    assert m == len(i_o) > 0
    np.testing.assert_array_equal(gst.core.idcs.numpy()[:m], i_o)
    np.testing.assert_array_equal(gst.core.pts.numpy()[:m], p_o)
    np.testing.assert_allclose(gst.core.wts.numpy()[:m], w_o, rtol=1e-6, atol=1e-9)
    if dedup:
        assert int(sel_o.sum()) == itrs


def test_onehot_and_scatter_reductions_build_alike(gauss, monkeypatch):
    """The scatter reduction above the one-hot gate builds the trajectory
    of the one-hot product (the gate patched, as tests/test_groups.py
    patches the JAX one), and both equal the JAX build."""
    X, samples, Siginv, logdet, groups = gauss
    cfg = IncrementalConfig(projection_dim=GS, opt_itrs=10, i0=0.5)
    b1, g1, _ = _deterministic_port(X, samples, Siginv, logdet, groups, cfg, 3)
    b2, g2, _ = _deterministic_port(X, samples, Siginv, logdet, groups, cfg, 3, gate=0,
                                    monkeypatch=monkeypatch)
    assert b1.onehot is not None and b2.onehot is None
    np.testing.assert_array_equal(g1.selected.numpy(), g2.selected.numpy())
    np.testing.assert_array_equal(g1.core.idcs.numpy(), g2.core.idcs.numpy())
    np.testing.assert_allclose(g1.core.wts.numpy(), g2.core.wts.numpy(), rtol=1e-12,
                               atol=1e-12)
    jb = j_builder(jnp.asarray(X), JGroups.from_lists(groups),
                   j_gauss.bundle(jnp.asarray(Siginv), logdet), j_fixed(jnp.asarray(samples)),
                   JConfig(projection_dim=GS, opt_itrs=10, i0=0.5))
    jg = jb(jax.random.key(3), j_init_gst(j_init_state(60, GD, dtype=jnp.float64),
                                          len(groups)), 3)
    _assert_same_group_build(g2, jg, tol=1e-9)


def test_append_never_writes_past_the_capacity(gauss):
    """A buffer of 16 slots: the groups of 20 never fit and those that no
    longer fit are masked out of the argmax, so the build fills whole
    groups only, leaves every slot past m as padding and equals the JAX
    build (whose scatter drops out-of-range positions)."""
    X, samples, Siginv, logdet, groups = gauss
    cfg = IncrementalConfig(projection_dim=GS, opt_itrs=10, i0=0.5, dedup_select=True)
    _, gst, _ = _deterministic_port(X, samples, Siginv, logdet, groups, cfg, 6, M=16)
    m = int(gst.core.m)
    sel = np.flatnonzero(gst.selected.numpy())
    assert 0 < m <= 16 and m == sum(SIZES[g] for g in sel) and 3 not in sel
    np.testing.assert_array_equal(np.sort(gst.core.idcs.numpy()[:m]),
                                  np.sort([i for g in sel for i in groups[g]]))
    assert (gst.core.idcs.numpy()[m:] == -1).all() and (gst.core.wts.numpy()[m:] == 0).all()
    np.testing.assert_array_equal(gst.core.pts.numpy()[m:], 0.0)
    jb = j_builder(jnp.asarray(X), JGroups.from_lists(groups),
                   j_gauss.bundle(jnp.asarray(Siginv), logdet), j_fixed(jnp.asarray(samples)),
                   JConfig(projection_dim=GS, opt_itrs=10, i0=0.5, dedup_select=True))
    jg = jb(jax.random.key(0), j_init_gst(j_init_state(16, GD, dtype=jnp.float64),
                                          len(groups)), 6)
    _assert_same_group_build(gst, jg, tol=1e-9)


# --- builds under the JAX build's draws ---------------------------------------------


def _against_jax(problem, key, dtype=np.float64, weights=None, initialized=0,
                 warm=None, M=240, **change):
    """(port group state, JAX group state) of one build of ITRS selections
    from the same state under the JAX build's draws."""
    Z, groups = problem
    Z = Z.astype(dtype)
    kw = dict(projection_dim=LS, n_subsample_select=30, n_subsample_opt=150, opt_itrs=LT,
              i0=0.5, use_beta=True)
    kw.update(change)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    if warm is None:
        st0 = j_init_state(M, LD, beta=0.2, dtype=jdt, sampler_aux=jnp.zeros(LD, jdt))
    else:
        st0 = j_warm_state(M, *warm, beta=0.2, sampler_aux=jnp.zeros(LD, jdt))
    gst0 = j_init_gst(st0, len(groups), initialized=initialized)
    u = None if weights is None else jnp.asarray(weights.astype(dtype))
    jg = j_builder(jnp.asarray(Z), JGroups.from_lists(groups), j_logreg.bundle(), j_laplace(),
                   JConfig(**kw), data_weights=u)(key, gst0, ITRS)
    builder = make_group_incremental_builder(
        torch.from_numpy(Z), Groups.from_lists(groups, device="cpu"), logreg.bundle(),
        logreg_laplace_sampler(), IncrementalConfig(**kw),
        data_weights=None if weights is None else torch.from_numpy(weights.astype(dtype)))
    draws = replay_jax_draws(key, st0, ITRS, j_laplace(), LN, LS, LT,
                             kw["n_subsample_select"], kw["n_subsample_opt"], n_cand=len(groups))
    tg = builder.build(group_state_from_numpy(_np_gst(gst0), device="cpu"), ITRS, draws)
    return tg, jg


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
def test_group_build_matches_jax_under_jax_draws(logistic, dedup, full):
    """Subsampled (30 group candidates, 150 refinement rows, float64) or
    full (every group, every row, float32)."""
    change = dict(n_subsample_select=None, n_subsample_opt=None) if full else {}
    tg, jg = _against_jax(logistic, jax.random.PRNGKey(3),
                          np.float32 if full else np.float64, dedup_select=dedup, **change)
    _assert_same_group_build(tg, jg)
    assert int(tg.selected.sum()) >= 3


@pytest.mark.parametrize("full", [False, True])
def test_weighted_group_build_matches_jax(logistic, full):
    """Groups 1 and 3 weigh nothing and half of group 4's rows weigh 0:
    the weighted reduction, the zero-mass mask and the stable partition
    of the append, as the JAX build does them; no zero-weight row enters."""
    Z, groups = logistic
    u = np.ones(LN)
    u[groups[1]] = 0.0
    u[groups[3]] = 0.0
    u[groups[4][: len(groups[4]) // 2]] = 0.0
    u[groups[7]] = 2.0
    change = dict(n_subsample_select=None, n_subsample_opt=None) if full else {}
    tg, jg = _against_jax(logistic, jax.random.PRNGKey(5), weights=u, dedup_select=True,
                          **change)
    _assert_same_group_build(tg, jg)
    m = int(tg.core.m)
    assert (u[tg.core.idcs.numpy()[:m]] > 0).all()
    assert not tg.selected.numpy()[[1, 3]].any()


def test_initialized_build_matches_jax(logistic):
    """Three warm-start slots with indices outside the data, left out of
    the take-new comparison (``initialized``)."""
    Z, _ = logistic
    rng = np.random.default_rng(0)
    warm = (np.ones(3), np.arange(10_000_000, 10_000_003), Z[:3] * 3.0
            + rng.normal(size=(3, LD)))
    tg, jg = _against_jax(logistic, jax.random.PRNGKey(7), initialized=3, warm=warm)
    _assert_same_group_build(tg, jg)
    np.testing.assert_array_equal(tg.core.idcs.numpy()[:3], warm[1])


@pytest.mark.parametrize("full", [False, True])
def test_lagged_refits_match_jax(logistic, full):
    """refit_every = 4: the posterior refitted every 4th refinement step,
    on a subsample or on every row (the reference's group builder lags
    both)."""
    change = dict(n_subsample_select=None, n_subsample_opt=None) if full else {}
    tg, jg = _against_jax(logistic, jax.random.PRNGKey(11), refit_every=4, **change)
    _assert_same_group_build(tg, jg)


def test_build_trace_matches_build_and_jax(logistic):
    """build_trace: the same final state as build under the same draws,
    the selected trace monotone and equal to the JAX build_trace's."""
    Z, groups = logistic
    key = jax.random.PRNGKey(13)
    kw = dict(projection_dim=LS, n_subsample_select=30, n_subsample_opt=150, opt_itrs=LT,
              i0=0.5, use_beta=True)
    st0 = j_init_state(240, LD, beta=0.2, dtype=jnp.float64,
                       sampler_aux=jnp.zeros(LD, jnp.float64))
    gst0 = j_init_gst(st0, len(groups))
    _, (_, _, _, jsel) = j_builder(jnp.asarray(Z), JGroups.from_lists(groups),
                                   j_logreg.bundle(), j_laplace(),
                                   JConfig(**kw)).build_trace(key, gst0, ITRS)
    builder = make_group_incremental_builder(
        torch.from_numpy(Z), Groups.from_lists(groups, device="cpu"), logreg.bundle(),
        logreg_laplace_sampler(), IncrementalConfig(**kw))
    draws = replay_jax_draws(key, st0, ITRS, j_laplace(), LN, LS, LT, 30, 150,
                             n_cand=len(groups))
    g0 = group_state_from_numpy(_np_gst(gst0), device="cpu")
    gt, (W, I, B, Sel) = builder.build_trace(g0, ITRS, draws)
    gb = builder.build(g0, ITRS, draws)
    assert W.shape == (ITRS, 240) and Sel.shape == (ITRS, len(groups))
    np.testing.assert_array_equal(gt.core.wts.numpy(), gb.core.wts.numpy())
    np.testing.assert_array_equal(W[-1].numpy(), gb.core.wts.numpy())
    np.testing.assert_array_equal(I[-1].numpy(), gb.core.idcs.numpy())
    np.testing.assert_array_equal(Sel.numpy(), np.asarray(jsel))
    assert (Sel[1:].int() >= Sel[:-1].int()).all()


def test_group_state_from_numpy_round_trips(logistic):
    _, groups = logistic
    st = j_init_state(8, LD, beta=0.3, dtype=jnp.float64)
    gst = j_init_gst(st, len(groups), selected=np.arange(len(groups)) % 3 == 0, initialized=2)
    got = group_state_from_numpy(_np_gst(gst), device="cpu")
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(gst.selected))
    assert got.selected.dtype == torch.bool and int(got.initialized) == 2
    assert got.initialized.dtype == torch.int32
    for k, v in state_to_numpy(got.core).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(st, k)))


# --- the object API ---------------------------------------------------------------


def _feed_jax_group_draws(alg, seed):
    """The port object takes the draws of the JAX object of the same seed:
    each build replays the next key of the JAX KeySequence."""
    keys = JKeySequence(seed)
    cfg, G = alg._cfg, len(alg.groups)
    jst = j_init_state(alg.state.wts.shape[0], LD, dtype=jnp.float64,
                       sampler_aux=jnp.zeros(LD, jnp.float64))
    alg._draws = lambda itrs: replay_jax_draws(
        keys(), jst, itrs, j_laplace(), LN, cfg.projection_dim, cfg.opt_itrs,
        cfg.n_subsample_select, cfg.n_subsample_opt, n_cand=G)
    return alg


def _api_pair(problem, cls, seed, **kw):
    Z, groups = problem
    kw = dict(n_subsample_select=30, n_subsample_opt=150, opt_itrs=LT,
              step_sched=lambda i: 0.5 / (1.0 + i), seed=seed, groups=groups, **kw)
    if cls == "BetaCoreset":
        kw["beta"] = 0.2
        jprj = jbc.BetaBlackBoxProjector(j_laplace(), LS, model=j_logreg.bundle())
        tprj = bc.BetaBlackBoxProjector(logreg_laplace_sampler(), LS, model=logreg.bundle())
    else:
        jprj = jbc.BlackBoxProjector(j_laplace(), LS, model=j_logreg.bundle())
        tprj = bc.BlackBoxProjector(logreg_laplace_sampler(), LS, model=logreg.bundle())
    ja = getattr(jbc, cls)(jnp.asarray(Z), jprj, **kw)
    ta = _feed_jax_group_draws(getattr(bc, cls)(Z, tprj, device="cpu", **kw), seed)
    return ja, ta


@pytest.mark.parametrize("cls", ["BetaCoreset", "SparseVICoreset"])
def test_api_group_mode_under_jax_draws(logistic, cls):
    """groups= on the object: build(1, .) three times and then a
    build_trace(2, return_selected=True) take the JAX object's selections;
    optimize() leaves a group coreset alone; error() is finite."""
    ja, ta = _api_pair(logistic, cls, 7)
    cap = ta.state.wts.shape[0]
    assert cap == ja.state.wts.shape[0] >= sum(len(g) for g in logistic[1])
    for _ in range(3):
        ja.build(1, LN)
        ta.build(1, LN)
    jt, jsel = ja.build_trace(2, return_selected=True)
    tt, tsel = ta.build_trace(2, return_selected=True)
    assert ta.selected_groups == ja.selected_groups and len(ta.selected_groups) >= 2
    np.testing.assert_array_equal(tsel, np.asarray(jsel))
    for (tw, tp, ti, tb), (jw, jp, ji, jb_) in zip(tt, jt):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tw, jw, atol=5e-3 * max(1.0, np.abs(jw).max()))
        np.testing.assert_array_equal(tp, jp)
        assert tb == pytest.approx(jb_)
    before = ta.state
    err = ta.error()
    ta.optimize()
    assert np.isfinite(err) and ta.state.wts is before.wts
    with pytest.raises(ValueError, match="group mode only"):
        bc.SparseVICoreset(logistic[0], ta.projector, device="cpu").build_trace(
            1, return_selected=True)


def test_api_group_refine_and_reset(gauss):
    """refine() polishes the appended members only; reset() empties the
    coreset and its selected groups."""
    X, samples, Siginv, logdet, groups = gauss
    model = gaussian.bundle(torch.from_numpy(Siginv), logdet)
    prj = bc.BlackBoxProjector(fixed_sampler(torch.from_numpy(samples)), GS, model=model)
    alg = bc.SparseVICoreset(X, prj, opt_itrs=8, groups=groups, seed=9, device="cpu")
    alg.build(3, GN)
    m = int(alg.state.m)
    support = set(alg.state.idcs.numpy()[:m].tolist())
    alg.refine(n_samples=32)
    w, _, i = alg.get()
    assert (w >= 0).all() and set(i.tolist()) <= support
    assert alg.selected_groups
    alg.reset()
    assert alg.selected_groups == [] and int(alg.state.m) == 0


def _feed_jax_group_stream(alg, seed, weights=None):
    """The port's uniform coreset drawing the JAX class's group stream."""
    key = jax.random.key(seed)
    n0 = [0]
    G = len(alg.groups)
    if weights is None:
        def draw(itrs):
            out = np.asarray(j_uniform_draws(key, itrs, G, n0[0]))
            n0[0] += itrs
            return out
    else:
        mass = np.array([weights[g].sum() for g in alg.groups])
        pos = np.flatnonzero(mass > 0)
        cdf = np.cumsum(mass[pos])
        cdf = jnp.asarray(cdf / cdf[-1])

        def draw(itrs):
            j = np.asarray(j_weighted_draws(key, itrs, start=n0[0], cdf=cdf))
            n0[0] += itrs
            return pos[j]
    alg._draw_groups = draw
    return alg


@pytest.mark.parametrize("weighted", [False, True])
def test_uniform_group_mode_matches_jax(gauss, weighted):
    """UniformSamplingCoreset(groups=) on the JAX group stream: the same
    selected groups, indices and weights (weighted: groups drawn by mass,
    u = 0 members left out, multiplicities u_n); build_trace equals the
    build(1, .) loop."""
    X, _, _, _, groups = gauss
    u = None
    if weighted:
        u = np.ones(GN)
        u[groups[2]] = 0.0
        u[groups[0][:2]] = 0.0
        u[groups[4]] = 3.0
    kw = {} if u is None else {"data_weights": u}
    ja = jbc.UniformSamplingCoreset(jnp.asarray(X), seed=3, groups=groups,
                                    **({} if u is None else {"data_weights": jnp.asarray(u)}))
    ta = _feed_jax_group_stream(bc.UniformSamplingCoreset(X, seed=3, groups=groups,
                                                          device="cpu", **kw), 3, u)
    for m in range(1, 5):
        ja.build(1, GN)
        ta.build(1, GN)
    assert ta.selected_groups == ja.selected_groups
    jw, _, ji = ja.get()
    tw, tp, ti = ta.get()
    order_t, order_j = np.argsort(ti), np.argsort(np.asarray(ji))
    np.testing.assert_array_equal(ti[order_t], np.asarray(ji)[order_j])
    np.testing.assert_allclose(tw[order_t], np.asarray(jw)[order_j], rtol=1e-12)
    np.testing.assert_array_equal(tp[order_t], X[ti[order_t]])
    if weighted:
        assert (u[ti] > 0).all() and 2 not in ta.selected_groups
    trace_alg = _feed_jax_group_stream(bc.UniformSamplingCoreset(X, seed=3, groups=groups,
                                                                 device="cpu", **kw), 3, u)
    wl, pl, il = trace_alg.build_trace(4)[-1]
    np.testing.assert_array_equal(np.sort(il), np.sort(ti))
    np.testing.assert_allclose(np.sort(wl), np.sort(tw), rtol=1e-12)
    assert trace_alg.selected_groups == ta.selected_groups


def test_uniform_group_mode_own_stream(gauss):
    """Without a fed stream: whole groups, weights summing to N, and a
    reset replays the same groups."""
    X, _, _, _, groups = gauss
    alg = bc.UniformSamplingCoreset(X, seed=5, groups=groups, device="cpu")
    alg.build(4, GN)
    w, _, i = alg.get()
    want = sorted(x for g in alg.selected_groups for x in groups[g])
    assert sorted(i.tolist()) == want
    np.testing.assert_allclose(w.sum(), GN, rtol=1e-12)
    first = list(alg.selected_groups)
    alg.reset()
    alg.build(4, GN)
    assert alg.selected_groups == first


# --- refusals ----------------------------------------------------------------------


def test_group_mode_refuses_learn_beta_and_contextual(gauss):
    X, samples, Siginv, logdet, groups = gauss
    model = gaussian.bundle(torch.from_numpy(Siginv), logdet)
    smp = fixed_sampler(torch.from_numpy(samples))
    prj = bc.BetaBlackBoxProjector(smp, GS, model=model)
    with pytest.raises(NotImplementedError, match="learn_beta"):
        bc.BetaCoreset(X, prj, beta=0.3, learn_beta=True, groups=groups, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7b"):
        make_group_incremental_builder(torch.from_numpy(X), Groups.from_lists(groups, "cpu"),
                                       model, smp, IncrementalConfig(projection_dim=GS),
                                       contextual=True)
    with pytest.raises(ValueError, match="refit_every"):
        make_group_incremental_builder(torch.from_numpy(X), Groups.from_lists(groups, "cpu"),
                                       model, smp,
                                       IncrementalConfig(projection_dim=GS, refit_every=2))
