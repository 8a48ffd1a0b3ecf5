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
