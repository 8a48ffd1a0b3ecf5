"""The port's damped-Newton Laplace fit (betacores_tpu_torch/inference/
laplace.py) and logistic-regression Laplace sampler against the JAX
package's, in float64 on the same inputs. The port runs a fixed number of
iterations and freezes its carry once the JAX while loop would have
stopped, so mode and factors agree to atol 1e-9 (float64 round-off of
the same Newton iterates)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference import laplace as jlaplace
from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu_torch.inference import laplace, logreg_laplace_sampler
from betacores_tpu_torch.models import logreg

torch.set_num_threads(1)
ATOL = 1e-9


@pytest.fixture
def problem():
    """Coreset-like inputs: 20 live rows, 12 zero-weight padded rows."""
    rng = np.random.default_rng(3)
    d = 6
    th = rng.normal(size=d)
    X = rng.normal(size=(32, d))
    y = np.where(X @ th + 0.5 * rng.normal(size=32) > 0, 1.0, -1.0)
    Z = y[:, None] * X
    w = rng.uniform(0.5, 4.0, size=32)
    w[20:] = 0.0
    return Z, w, th


def _fns(mod, Z, w):
    return (lambda t: mod.log_joint(Z, t, w), lambda t: mod.grad_th_log_joint(Z, t, w),
            lambda t: mod.hess_th_log_joint(Z, t, w))


def _fit_both(Z, w, mu0, with_inverse, n_iters=8):
    want = jlaplace.newton_laplace(*_fns(jlogreg, jnp.asarray(Z), jnp.asarray(w)),
                                   jnp.asarray(mu0), n_iters=n_iters,
                                   with_inverse=with_inverse)
    got = laplace.newton_laplace(*_fns(logreg, torch.from_numpy(Z), torch.from_numpy(w)),
                                 torch.from_numpy(mu0), n_iters=n_iters,
                                 with_inverse=with_inverse)
    return got, want


@pytest.mark.parametrize("with_inverse", [False, True])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_newton_laplace_matches_jax(problem, start, with_inverse):
    Z, w, th = problem
    mu0 = np.zeros(Z.shape[1]) if start == "cold" else 0.3 * th
    got, want = _fit_both(Z, w, mu0, with_inverse)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol),
                               atol=ATOL, rtol=0)
    if with_inverse:
        np.testing.assert_allclose(got.prec_chol_inv.numpy(),
                                   np.asarray(want.prec_chol_inv), atol=ATOL, rtol=0)
    else:
        assert got.prec_chol_inv is None and want.prec_chol_inv is None
    # the mode is a stationary point of the log joint, to the Newton
    # decrement's stopping tolerance
    g = logreg.grad_th_log_joint(torch.from_numpy(Z), got.mu, torch.from_numpy(w))
    assert float(g.abs().max()) < 1e-4


def test_newton_frozen_after_done_matches_short_budget(problem):
    """A budget of one iteration stops the JAX loop early: the port returns
    that same unconverged iterate, not a later one."""
    Z, w, _ = problem
    got, want = _fit_both(Z, w, np.zeros(Z.shape[1]), True, n_iters=1)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), atol=ATOL, rtol=0)


def test_sample_laplace_from_noise(problem):
    Z, w, _ = problem
    got, want = _fit_both(Z, w, np.zeros(Z.shape[1]), False)
    z = np.random.default_rng(0).normal(size=(50, Z.shape[1]))
    a = laplace.sample_laplace_from_noise(got, torch.from_numpy(z)).numpy()
    b = np.asarray(jlaplace.sample_laplace_from_noise(want, jnp.asarray(z)))
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    # theta = mu + z L^-1 with L^-1 from the inverse form: the fused step's transform
    inv, _ = _fit_both(Z, w, np.zeros(Z.shape[1]), True)
    np.testing.assert_allclose(inv.mu.numpy() + z @ inv.prec_chol_inv.numpy(), b,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("method", ["fit", "fit_inv"])
def test_sampler_fits_match_jax(problem, method):
    Z, w, th = problem
    aux = 0.5 * th
    want = getattr(jsampler(), method)(jnp.asarray(w), jnp.asarray(Z), jnp.asarray(aux))
    smp = logreg_laplace_sampler()
    got = getattr(smp, method)(torch.from_numpy(w), torch.from_numpy(Z),
                               torch.from_numpy(aux))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol),
                               atol=ATOL, rtol=0)
    assert torch.equal(smp.fit_aux(got), got.mu)


def test_sampler_noise_split_and_dtype(problem):
    """sampler == from_noise(draw_noise(...)) on one generator state, and the
    noise takes the promoted dtype of (wts, pts, aux), as the fitted mode."""
    Z, w, _ = problem
    smp = logreg_laplace_sampler()
    wt, Zt = torch.from_numpy(w).float(), torch.from_numpy(Z)
    aux = torch.zeros(Z.shape[1], dtype=torch.float32)
    z = smp.draw_noise(torch.Generator().manual_seed(1), 7, wt, Zt, aux)
    assert z.shape == (7, Z.shape[1]) and z.dtype == torch.float64
    samples, mode = smp(torch.Generator().manual_seed(1), 7, wt, Zt, aux)
    ref, ref_mode = smp.from_noise(z, wt, Zt, aux)
    assert torch.equal(samples, ref) and torch.equal(mode, ref_mode)
    assert mode.dtype == z.dtype


def _diag_fns(mod, Z, w):
    return (lambda t: mod.log_joint(Z, t, w), lambda t: mod.grad_th_log_joint(Z, t, w),
            lambda t: mod.diag_hess_th_log_joint(Z, t, w))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_newton_laplace_diag_matches_jax(problem, start):
    """The diagonal-Hessian Newton: a fixed 12-iteration loop on both sides
    (no early exit in either), so mode and diagonal factor agree to
    float64 round-off."""
    Z, w, th = problem
    mu0 = np.zeros(Z.shape[1]) if start == "cold" else 0.3 * th
    want = jlaplace.newton_laplace_diag(*_diag_fns(jlogreg, jnp.asarray(Z), jnp.asarray(w)),
                                        jnp.asarray(mu0), n_iters=12)
    got = laplace.newton_laplace_diag(*_diag_fns(logreg, torch.from_numpy(Z),
                                                 torch.from_numpy(w)),
                                      torch.from_numpy(mu0), n_iters=12)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol),
                               atol=1e-10, rtol=0)
    L = got.prec_chol.numpy()
    assert (L == np.diag(np.diag(L))).all() and (np.diag(L) > 0).all()


def test_diag_sampler_fit_and_draws_match_jax(problem):
    """``logreg_laplace_sampler(diag=True)``: n_newton + 4 iterations, its
    fit and its samples from the same noise, within 1e-10; it has no
    ``fit_inv``, as in the reference."""
    Z, w, th = problem
    rng = np.random.default_rng(4)
    z = rng.normal(size=(16, Z.shape[1]))
    aux = 0.1 * th
    js, ts = jsampler(diag=True), logreg_laplace_sampler(diag=True)
    assert getattr(ts, "fit_inv", None) is None and getattr(js, "fit_inv", None) is None
    want = js.fit(jnp.asarray(w), jnp.asarray(Z), jnp.asarray(aux))
    got = ts.fit(*(torch.from_numpy(a) for a in (w, Z, aux)))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol),
                               atol=1e-10, rtol=0)
    s_want, a_want = js.from_noise(jnp.asarray(z), jnp.asarray(w), jnp.asarray(Z),
                                   jnp.asarray(aux))
    s_got, a_got = ts.from_noise(*(torch.from_numpy(a) for a in (z, w, Z, aux)))
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), atol=1e-10, rtol=0)
    np.testing.assert_allclose(a_got.numpy(), np.asarray(a_want), atol=1e-10, rtol=0)


@pytest.mark.parametrize("with_inverse", [False, True])
def test_indefinite_hessian_gives_the_reference_nan_factor(with_inverse):
    """A target whose -H is not positive definite ([[1, 2], [2, 1]]): the
    reference's Cholesky gives NaN in the factor's lower triangle, its
    Newton direction is NaN, every candidate scores -inf and the step is
    rejected. The port returns the same: mu0, and NaN exactly where the
    JAX factor (and L^-1) has NaN."""
    negH = np.array([[1.0, 2.0], [2.0, 1.0]])
    b = np.array([0.3, -0.2])
    mu0 = np.array([0.5, 0.25])

    def fns(xp, asarr):
        A, bb = asarr(negH), asarr(b)
        return (lambda t: -0.5 * ((t @ A) * t).sum(-1) + t @ bb,
                lambda t: bb - A @ t, lambda t: -A)

    want = jlaplace.newton_laplace(*fns(jnp, jnp.asarray), jnp.asarray(mu0), n_iters=8,
                                   with_inverse=with_inverse)
    got = laplace.newton_laplace(*fns(torch, torch.from_numpy), torch.from_numpy(mu0),
                                 n_iters=8, with_inverse=with_inverse)
    np.testing.assert_array_equal(got.mu.numpy(), np.asarray(want.mu))
    np.testing.assert_array_equal(got.mu.numpy(), mu0)
    pairs = [(got.prec_chol, want.prec_chol)]
    if with_inverse:
        pairs.append((got.prec_chol_inv, want.prec_chol_inv))
    for g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert np.isnan(w).any()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g[~np.isnan(g)], w[~np.isnan(w)])
