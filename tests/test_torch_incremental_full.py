"""The single-device builder's full-data refinement (``n_subsample_opt=None``)
and base-data weights (``data_weights``) in
betacores_tpu_torch/coresets/incremental.py: against the JAX builder under
its own replayed draws (the recipe of test_torch_incremental.py), and
against the NumPy oracle's golden builds (oracle/coresets.py), which score
every row and refine on every row under fixed posterior samples.

Against JAX both compute in float32 on the well-separated problem of
test_torch_incremental.py: selections exactly, weights within
5e-3 * max(1, max|w|). Against the oracle both compute in float64 with the
same samples at every step: the same support, weights within rtol 1e-6,
atol 1e-9 (the JAX package's own golden tolerance,
tests/test_coresets.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu_torch.coresets import (FixedDraws, IncrementalConfig, get, init_state,
                                         make_incremental_builder, state_from_numpy,
                                         state_to_numpy)
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from oracle import coresets as ocs
from oracle import models as om
from test_torch_incremental import (BETA, D, I0, ITRS, N, N_OPT, N_SEL, S, T,
                                    _assert_same_build, _jax_state, _np_state,
                                    replay_jax_draws)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return (y[:, None] * X).astype(np.float32)


def _against_jax(problem, key, weights=None, **change):
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=I0, use_beta=True)
    kw.update(change)
    st0 = _jax_state()
    u = None if weights is None else jnp.asarray(weights)
    jst = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(),
                   JConfig(fused_grad_step=True, **kw), data_weights=u).build(key, st0, ITRS)
    builder = make_incremental_builder(
        torch.from_numpy(problem), logreg.bundle(), logreg_laplace_sampler(),
        IncrementalConfig(**kw), data_weights=None if weights is None
        else torch.from_numpy(weights))
    draws = replay_jax_draws(key, st0, ITRS, jsampler(), N, S, T,
                             kw["n_subsample_select"], kw["n_subsample_opt"])
    got = state_to_numpy(builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS,
                                            draws))
    return builder, got, _np_state(jst)


@pytest.mark.parametrize("dedup", [False, True])
def test_full_data_build_matches_jax(problem, dedup):
    """Every row scored and every row in each refinement step's target."""
    builder, got, want = _against_jax(problem, jax.random.PRNGKey(13), dedup_select=dedup,
                                      n_subsample_select=None, n_subsample_opt=None)
    assert builder.n_opt is None and builder.fstep is None
    _assert_same_build(got, want)


def _zero_tail(n_zero=1000):
    u = np.ones(N, np.float32)
    u[n_zero:] = 0.0
    return u


@pytest.mark.parametrize("full", [False, True])
def test_weighted_build_matches_jax(problem, full):
    """Zero weights on the last rows: the composed route (subsampled) or
    the full-data route, as in the reference; no zero-weight row is
    selected."""
    change = dict(n_subsample_select=None, n_subsample_opt=None) if full else {}
    builder, got, want = _against_jax(problem, jax.random.PRNGKey(17), _zero_tail(),
                                      **change)
    assert builder.fstep is None
    _assert_same_build(got, want)
    assert (got["idcs"][:int(got["m"])] < 1000).all()


def test_unit_weights_select_as_unweighted(problem):
    """u = ones takes the composed route, the unweighted build the fused
    step; under the same draws they select the same rows."""
    key = jax.random.PRNGKey(19)
    _, ones, _ = _against_jax(problem, key, np.ones(N, np.float32))
    builder, plain, _ = _against_jax(problem, key)
    assert builder.fstep is not None
    _assert_same_build(ones, plain)


class FixedSamples:
    """A sampler whose posterior samples are fixed: the oracle's
    deterministic ``sampler_fn``."""

    def __init__(self, samples):
        self.samples = samples

    def draw_noise(self, generator, n, wts, pts, aux):
        return torch.zeros((n, self.samples.shape[1]), dtype=self.samples.dtype)

    def from_noise(self, z, wts, pts, aux):
        return self.samples[:z.shape[0]], aux


def _golden_setup(seed=0, n=60, d=3, n_samples=8):
    rng = np.random.default_rng(seed)
    th = rng.normal(size=d)
    X = rng.normal(size=(n, d))
    y = np.where(X @ th + 0.5 * rng.normal(size=n) > 0, 1.0, -1.0)
    return y[:, None] * X, rng.normal(size=(n_samples, d))


def _golden_port(Z, samples, M, opt_itrs, beta, dedup=False, u=None):
    smp = FixedSamples(torch.from_numpy(samples))
    cfg = IncrementalConfig(projection_dim=samples.shape[0], n_subsample_select=None,
                            n_subsample_opt=None, opt_itrs=opt_itrs, i0=0.5,
                            use_beta=True, dedup_select=dedup)
    builder = make_incremental_builder(torch.from_numpy(Z), logreg.bundle(), smp, cfg,
                                       data_weights=None if u is None else torch.from_numpy(u))
    d = Z.shape[1]
    zeros = torch.zeros((samples.shape[0], d), dtype=torch.float64)
    draws = FixedDraws([(zeros, None)] * M, [(zeros.expand(opt_itrs, -1, -1), None)] * M)
    st = init_state(M, d, beta=beta, dtype=torch.float64, device="cpu")
    return get(builder.build(st, M, draws))


def _assert_same_support(got, want):
    w_got, _, i_got = got
    w_o, i_o, _ = want
    keep = w_o > 0
    np.testing.assert_array_equal(np.sort(i_got), np.sort(i_o[keep]))
    order_g, order_o = np.argsort(i_got), np.argsort(i_o[keep])
    np.testing.assert_allclose(w_got[order_g], w_o[keep][order_o], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dedup", [False, True])
def test_full_data_build_matches_oracle(dedup):
    """oracle/coresets.py:23-90 (incremental_build_deterministic): the
    beta-Cores skeleton without subsampling, in float64."""
    Z, samples = _golden_setup()
    M, opt_itrs, beta = 6, 25, 0.4
    lik = lambda pts, s: om.lr_beta_likelihood(pts, s, beta)
    want = ocs.incremental_build_deterministic(Z, M, opt_itrs, lambda i: 0.5 / (1.0 + i),
                                               lambda w, p: samples, lik, dedup=dedup)
    got = _golden_port(Z, samples, M, opt_itrs, beta, dedup)
    if dedup:
        assert len(got[2]) == M == len(set(got[2].tolist()))
    _assert_same_support(got, want)


def test_weighted_full_data_build_matches_oracle():
    """oracle/coresets.py:161 (incremental_build_weighted_deterministic):
    integer and zero base weights, in float64."""
    Z, samples = _golden_setup(seed=1)
    u = np.random.default_rng(2).integers(0, 3, size=Z.shape[0]).astype(np.float64)
    M, opt_itrs, beta = 6, 25, 0.4
    lik = lambda pts, s: om.lr_beta_likelihood(pts, s, beta)
    want = ocs.incremental_build_weighted_deterministic(
        Z, u, M, opt_itrs, lambda i: 0.5 / (1.0 + i), lambda w, p: samples, lik)
    got = _golden_port(Z, samples, M, opt_itrs, beta, u=u)
    assert (u[got[2]] > 0).all()
    _assert_same_support(got, want)
