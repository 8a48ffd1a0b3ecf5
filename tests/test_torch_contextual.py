"""The port's contextual builds (the neural-linear experiment's path,
examples/zellner_neural_linear.py) against the JAX package's, on the CPU.

- The example's host helpers (``standardize``, ``make_random_groups``,
  ``perturb_groups``) give the reference's arrays for the same seed, and
  ``perturb_regression`` its arrays under its draws.
- A contextual ``SparseVICoreset`` and ``BetaCoreset`` over points, and a
  contextual group ``BetaCoreset`` with the example's warm start (20 rows
  whose indices start at 10,000,000, ``initialized=True``), against the
  JAX classes under the JAX draws, with the context changed between
  builds as the example retrains its encoder. The JAX sampler draws its
  (S, F) normals one step at a time from the step's key; the port's has a
  noise split, so those normals are rebuilt from the JAX builder's keys
  (test_torch_incremental.py's recipe) and replayed. Pass: the same
  selected points or groups and m, weights within 5e-3 max(1, max|w|).
  The point builds run in float32; the group build in float64, where the
  subsampled refinement's Adam does not amplify float32 rounding from
  selection to selection (test_torch_groups.py).
- The context is live in the builder: after a change, a builder that ran
  under the old context (eager, ``graph=False``; its static buffers and
  passes are the captured route's) gives a fresh builder's result under
  the new one.
- The contextual ``refine()`` against the JAX one under its draws, in
  float64, weights within rtol 1e-5 (the polish is 600 FISTA iterations
  on the encoded block; the two differ by 2.7e-6 relative there).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betacores_tpu as jbc
import betacores_tpu_torch as bc
from betacores_tpu.data.loaders import make_random_groups as j_random_groups
from betacores_tpu.data.loaders import standardize as j_standardize
from betacores_tpu.data.perturb import perturb_groups as j_perturb_groups
from betacores_tpu.data.perturb import perturb_regression as j_perturb_regression
from betacores_tpu.models import neural_linear as jnl
from betacores_tpu.utils.prng import KeySequence as JKeySequence
from betacores_tpu_torch.coresets import init_group_state, make_group_incremental_builder
from betacores_tpu_torch.coresets import make_incremental_builder, state_from_numpy
from betacores_tpu_torch.coresets.incremental import IncrementalConfig
from betacores_tpu_torch.data import (RegressionCorruption, apply_regression_corruption,
                                      make_random_groups, perturb_groups, standardize)
from betacores_tpu_torch.models import neural_linear as tnl
from betacores_tpu_torch.ops.projection import Groups
from test_torch_incremental import replay_jax_draws

torch.set_num_threads(1)

N, D, F, S, T, GSIZE, INIT = 300, 4, 6, 16, 20, 10, 10
N_SEL, N_OPT, SIGSQ = 60, 50, 0.5


class _JaxNoise:
    """The (n, F) normals the JAX neural-linear sampler draws from a key
    (``sample_gaussian_prec`` in the posterior's dtype)."""

    def __init__(self, dtype):
        self.dtype = dtype

    def draw_noise(self, key, n, wts, pts, aux):
        return jax.random.normal(key, (n, F), dtype=self.dtype)


@pytest.fixture(scope="module")
def problem():
    """The example's synth path at a small size: standardised linear data
    in groups, 10 % of the groups corrupted; a JAX encoder trained for 3
    epochs on the initial rows (so its running statistics are its own)
    and the same one trained 3 epochs more (the next round's context)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(D, 1))
    X = rng.normal(size=(N + 100, D))
    Y = X @ w + np.sin(X[:, :1]) + 0.1 * rng.normal(size=(N + 100, 1))
    X, Xt, Y, Yt = X[:N], X[N:], Y[:N], Y[N:]
    Xi, Yi = X[:INIT].copy(), Y[:INIT].copy()
    X, Y, Xi, Yi, Xt, Yt, *_ = j_standardize(X, Y, Xi, Yi, Xt, Yt)
    groups = j_random_groups(rng, N, GSIZE)
    X, Y = j_perturb_groups(jax.random.key(2), X, Y, groups, f_rate=0.1)
    Z = np.hstack([np.asarray(X), np.asarray(Y)])
    Z_init = np.hstack([Xi, Yi])
    nl = jnl.NeuralLinear(Z_init.astype(np.float32), out_features=F, sigmasq=SIGSQ, seed=1)
    nl.optimize(np.ones(INIT, np.float32), Z_init.astype(np.float32), num_epochs=3)
    ctx1 = nl.variables
    nl.optimize(np.ones(INIT, np.float32), Z_init.astype(np.float32), num_epochs=3)
    return Z, Z_init, groups, nl, ctx1, nl.variables


def _np_vars(v):
    return jax.tree.map(np.asarray, dict(v))


def _tctx(v):
    return tnl.encoder_state_from_flax(_np_vars(v), device="cpu")


def _projectors(nl, dtype):
    mu0, S0 = 0.1 * np.ones(F), np.eye(F) / 2.0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    jprj = jbc.coresets.ContextualProjector(
        jnl.neural_linear_sampler_factory(nl.module, jnp.asarray(mu0, jdt),
                                          jnp.asarray(S0, jdt), SIGSQ), S,
        jnl.neural_linear_model_factory(nl.module, SIGSQ))
    enc = tnl.Encoder(D, F)
    tprj = bc.coresets.ContextualProjector(
        tnl.neural_linear_sampler_factory(enc, torch.tensor(mu0, dtype=dtype),
                                          torch.tensor(S0, dtype=dtype), SIGSQ), S,
        tnl.neural_linear_model_factory(enc, SIGSQ))
    return jprj, tprj


def _feed_jax_draws(alg, seed, dtype, n_sel, n_cand=None):
    """The port object takes the draws of the JAX object of the same seed."""
    keys = JKeySequence(seed)
    cfg = alg._cfg
    noise = _JaxNoise(jnp.float32 if dtype == torch.float32 else jnp.float64)
    st = SimpleNamespace(wts=None, pts=None, sampler_aux=None)    # the noise reads none
    alg._draws = lambda itrs: replay_jax_draws(
        keys(), st, itrs, noise, N, S, cfg.opt_itrs, n_sel, cfg.n_subsample_opt,
        n_cand=n_cand)
    return alg


def _assert_same(ta, ja, tol=5e-3):
    m = int(ja.state.m)
    assert int(ta.state.m) == m
    np.testing.assert_array_equal(ta.state.idcs.numpy(), np.asarray(ja.state.idcs))
    w0 = np.asarray(ja.state.wts)
    np.testing.assert_allclose(ta.state.wts.numpy(), w0, rtol=0,
                               atol=tol * max(1.0, np.abs(w0).max()))


# --- the example's host helpers -----------------------------------------------


def test_host_helpers_match_the_reference():
    rng = np.random.default_rng(0)
    X, Y = rng.normal(size=(50, 3)) * [1.0, 2.0, 0.0] + 1.0, rng.normal(size=(50, 1))
    Xt, Yt = rng.normal(size=(9, 3)), rng.normal(size=(9, 1))
    for got, want in zip(standardize(X, Y, Xt, Yt), j_standardize(X, Y, Xt, Yt)):
        np.testing.assert_array_equal(got, want)
    assert make_random_groups(np.random.default_rng(4), 53, 10) == j_random_groups(
        np.random.default_rng(4), 53, 10)
    groups = j_random_groups(np.random.default_rng(5), 50, 5)
    key = jax.random.key(6)
    want = j_perturb_groups(key, X, Y, groups, f_rate=0.4)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))       # the reference's seed
    for got in (perturb_groups(seed, X, Y, groups, f_rate=0.4),
                perturb_groups(np.random.default_rng(seed), X, Y, groups, f_rate=0.4)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert not np.array_equal(want[1], Y)


def test_perturb_regression_under_the_jax_draws():
    """The JAX draws (rows with repeats, columns, noise, responses) applied
    by the port give the JAX arrays: a repeated row keeps its last draw."""
    rng = np.random.default_rng(3)
    X, y = rng.normal(size=(40, 6)), rng.normal(size=(40, 1))
    key = jax.random.key(11)
    f_rate, o = 0.5, 20
    kx, kc, kn, kyn = jax.random.split(key, 4)
    rows = np.asarray(jax.random.randint(kx, (o,), 0, 40))
    assert len(np.unique(rows)) < o                               # repeats are exercised
    cols = np.asarray(jax.random.choice(kc, 6, (3,), replace=False))
    draws = RegressionCorruption(
        torch.tensor(rows).long(), torch.tensor(cols).long(),
        torch.from_numpy(np.asarray(1.0 + 10.0 * jax.random.normal(kn, (o, 3)))),
        torch.from_numpy(np.asarray(5.0 * jax.random.normal(kyn, (o,)))))
    gX, gy = apply_regression_corruption(torch.from_numpy(X), torch.from_numpy(y), draws)
    wX, wy = j_perturb_regression(key, jnp.asarray(X), jnp.asarray(y), f_rate=f_rate)
    np.testing.assert_array_equal(gX.numpy(), np.asarray(wX))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    gen = torch.Generator().manual_seed(0)
    a = bc.data.perturb_regression(gen, torch.from_numpy(X), torch.from_numpy(y), f_rate=f_rate)
    assert a[0].shape == X.shape and a[1].shape == y.shape and not torch.equal(
        a[1], torch.from_numpy(y))


# --- contextual builds under the JAX draws ---------------------------------------


@pytest.mark.parametrize("cls", ["SparseVICoreset", "BetaCoreset"])
def test_contextual_point_build_matches_jax(problem, cls):
    """Four build(1, m) under one context, then two under the retrained
    encoder's; ``error()`` runs under the context."""
    Z, _, _, nl, ctx1, ctx2 = problem
    Z32 = Z.astype(np.float32)
    jprj, tprj = _projectors(nl, torch.float32)
    kw = dict(n_subsample_select=N_SEL, n_subsample_opt=N_OPT, opt_itrs=T,
              step_sched=lambda i: 0.1 / (1.0 + i), seed=5, max_size=8)
    if cls == "BetaCoreset":
        kw.update(beta=0.5, learn_beta=False)
    ja = getattr(jbc, cls)(jnp.asarray(Z32), jprj, **kw)
    ta = _feed_jax_draws(getattr(bc, cls)(Z32, tprj, device="cpu", **kw), 5, torch.float32,
                         N_SEL)
    for m, ctx in ((1, ctx1), (2, ctx1), (3, ctx1), (4, ctx1), (5, ctx2), (6, ctx2)):
        ja.ctx, ta.ctx = ctx, _tctx(ctx)
        ja.build(1, m)
        ta.build(1, m)
        _assert_same(ta, ja)
    assert int(ta.state.m) >= 4
    assert np.isfinite(ta.error())


def test_contextual_group_build_with_the_examples_warm_start(problem):
    """The example's BCORES: every group scored, 50 refinement rows, a
    warm start of INIT rows outside the data, float64; the encoder retrained
    between rounds; then ``build_trace`` and the selected groups."""
    Z, Z_init, groups, nl, ctx1, ctx2 = problem
    jprj, tprj = _projectors(nl, torch.float64)
    kw = dict(beta=0.5, learn_beta=False, opt_itrs=T, n_subsample_opt=N_OPT,
              step_sched=lambda i: 0.1 / (1.0 + i), seed=1, wts=np.ones(INIT),
              idcs=10_000_000 + np.arange(INIT), pts=Z_init, groups=groups,
              initialized=True)
    ja = jbc.BetaCoreset(jnp.asarray(Z), jprj, **kw)
    ta = _feed_jax_draws(bc.BetaCoreset(Z, tprj, device="cpu", **kw), 1, torch.float64, None,
                         n_cand=len(groups))
    for ctx in (ctx1, ctx1, ctx2):
        ja.ctx, ta.ctx = ctx, _tctx(ctx)
        ja.build(1, N + INIT)
        ta.build(1, N + INIT)
        _assert_same(ta, ja)
        assert ta.selected_groups == ja.selected_groups
    jt, jsel = ja.build_trace(2, return_selected=True)
    tt, tsel = ta.build_trace(2, return_selected=True)
    np.testing.assert_array_equal(tsel, np.asarray(jsel))
    for (tw, tp, ti, _), (jw, jp, ji, _) in zip(tt, jt):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(tw, jw, atol=5e-3 * max(1.0, np.abs(jw).max()))
    assert len(ta.selected_groups) >= 3
    np.testing.assert_array_equal(ta.get()[2][:INIT], 10_000_000 + np.arange(INIT))


@pytest.mark.parametrize("group", [False, True])
def test_a_changed_ctx_reaches_the_builders_passes(problem, group):
    """A builder that built under one context and then builds under
    another equals a fresh builder under the second; under the first it
    would build otherwise."""
    Z, _, groups, nl, ctx1, ctx2 = problem
    _, tprj = _projectors(nl, torch.float64)
    cfg = IncrementalConfig(projection_dim=S, n_subsample_select=None if group else N_SEL,
                            n_subsample_opt=N_OPT, opt_itrs=T, use_beta=True)
    Zt = torch.from_numpy(Z)

    def make():
        if group:
            return make_group_incremental_builder(Zt, Groups.from_lists(groups, "cpu"),
                                                  tprj.model, tprj.sampler, cfg,
                                                  contextual=True, graph=False)
        return make_incremental_builder(Zt, tprj.model, tprj.sampler, cfg, graph=False,
                                        contextual=True)

    st0 = bc.init_state(64, D + 1, beta=0.5, dtype=torch.float64, device="cpu")
    if group:
        st0 = init_group_state(st0, len(groups))
    b = make()
    draws = lambda seed: b.generator_draws(torch.Generator().manual_seed(seed))
    st1 = b.build(st0, 2, draws(1), ctx=_tctx(ctx1))
    got = b.build(st1, 2, draws(2), ctx=_tctx(ctx2))
    want = make().build(st1, 2, draws(2), ctx=_tctx(ctx2))
    old = make().build(st1, 2, draws(2), ctx=_tctx(ctx1))
    core = (lambda s: s.core) if group else (lambda s: s)
    for u, v in zip(core(got), core(want)):
        assert torch.equal(u, v)
    assert not torch.equal(core(got).wts, core(old).wts)
    with pytest.raises(ValueError, match="names"):
        b.build(st1, 1, draws(3), ctx={"x": torch.zeros(1)})


def test_contextual_refine_matches_jax(problem):
    """refine() resolves the factories at the current context; fed the JAX
    object's next key's draws it polishes as the JAX one does."""
    Z, _, _, nl, ctx1, _ = problem
    jprj, tprj = _projectors(nl, torch.float64)
    kw = dict(opt_itrs=T, n_subsample_select=N_SEL, n_subsample_opt=N_OPT, seed=2,
              dedup_select=True, step_sched=lambda i: 0.1 / (1.0 + i))
    ja = jbc.SparseVICoreset(jnp.asarray(Z), jprj, **kw)
    ja.ctx = ctx1
    ja.build(5, 5)
    ta = bc.SparseVICoreset(Z, tprj, device="cpu", **kw)
    ta.state = state_from_numpy({k: np.asarray(v) for k, v in ja.state._asdict().items()},
                                device="cpu")
    with pytest.raises(ValueError, match="needs its ctx"):
        ta.refine(n_samples=32)
    ta.ctx = _tctx(ctx1)
    key = JKeySequence(ja.keys._key)()           # the key ja.refine() takes next
    k_samp, _ = jax.random.split(key)
    z = torch.from_numpy(np.asarray(jax.random.normal(k_samp, (32, F), dtype=jnp.float64)))
    ta._refine_draws = lambda: (z, None)
    before = np.asarray(ja.state.wts)
    ja.refine(n_samples=32)
    ta.refine(n_samples=32)
    assert not np.array_equal(np.asarray(ja.state.wts), before), "the polish was not kept"
    np.testing.assert_allclose(ta.state.wts.numpy(), np.asarray(ja.state.wts), rtol=1e-5,
                               atol=1e-9)
