"""The port's logistic-regression model (betacores_tpu_torch/models/logreg.py)
against betacores_tpu.models.logreg, in float64 on the same inputs, margins
of +-50 included. Tolerance atol 1e-10: both sides evaluate the same
closed forms in float64; only the order of the sums differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.models import logreg as jlogreg
from betacores_tpu_torch.models import logreg

torch.set_num_threads(1)
ATOL = 1e-10


@pytest.fixture
def inputs():
    rng = np.random.default_rng(7)
    Z = rng.normal(size=(40, 4))
    Z[0] = [25.0, 0.0, 0.0, 0.0]     # margins of +-50 against th[:, 0] = +-2
    Z[1] = [-25.0, 0.0, 0.0, 0.0]
    TH = rng.normal(size=(9, 4))
    TH[0, 0], TH[1, 0] = 2.0, -2.0
    w = rng.uniform(size=40) * 3
    w[-5:] = 0.0                     # zero-weight padded rows
    return Z, TH, w


def _both(fn_j, fn_t, *args):
    got = fn_t(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    want = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    return got.numpy(), np.asarray(want)


def test_log_likelihood(inputs):
    Z, TH, _ = inputs
    got, want = _both(jlogreg.log_likelihood, logreg.log_likelihood, Z, TH)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert np.abs(Z @ TH.T).max() >= 50.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("beta", [0.1, 0.5])
def test_beta_likelihood(inputs, beta):
    Z, TH, _ = inputs
    got, want = _both(jlogreg.beta_likelihood, logreg.beta_likelihood, Z, TH, beta)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["log_joint", "grad_th_log_joint", "hess_th_log_joint"])
def test_joint_and_derivatives(inputs, fn):
    Z, TH, w = inputs
    for th in TH[:3]:
        got, want = _both(getattr(jlogreg, fn), getattr(logreg, fn), Z, th, w)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-13)


def test_log_joint_batched_candidates(inputs):
    """The port's log_joint also takes a (K, d) batch of candidates (Newton's
    line search): each row equals the single-theta value."""
    Z, TH, w = inputs
    batched = logreg.log_joint(torch.from_numpy(Z), torch.from_numpy(TH),
                               torch.from_numpy(w)).numpy()
    want = [float(jlogreg.log_joint(jnp.asarray(Z), jnp.asarray(th), jnp.asarray(w)))
            for th in TH]
    np.testing.assert_allclose(batched, want, atol=ATOL, rtol=1e-13)


def test_log_prior(inputs):
    _, TH, _ = inputs
    got, want = _both(jlogreg.log_prior, logreg.log_prior, TH[0])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_softplus_matches_jax_in_float64():
    import jax

    m = np.linspace(-60.0, 60.0, 2001)
    np.testing.assert_allclose(logreg.softplus(torch.from_numpy(m)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(m))),
                               atol=1e-15, rtol=1e-15)


def test_bundle_attaches_the_fused_step():
    b = logreg.bundle()
    assert b.fused_ll_grad_step is not None and b.fused_beta_grad_step is not None
    assert b.log_likelihood is logreg.log_likelihood


@pytest.mark.parametrize("name", ["log_likelihood", "beta_likelihood", "log_joint",
                                  "grad_th_log_joint", "hess_th_log_joint"])
def test_matches_numpy_oracle(inputs, name):
    """The f64 NumPy golden (oracle/models.py) agrees as well."""
    from oracle import models as oracle

    Z, TH, w = inputs
    args = {"log_likelihood": (Z, TH), "beta_likelihood": (Z, TH, 0.3)}.get(
        name, (Z, TH[2], w))
    got = getattr(logreg, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                  for a in args)).numpy()
    np.testing.assert_allclose(got, getattr(oracle, "lr_" + name)(*args),
                               atol=ATOL, rtol=1e-13)


def test_diag_hess_th_log_joint(inputs):
    """The Hessian's diagonal, and equal to the full Hessian's diagonal."""
    Z, TH, w = inputs
    got, want = _both(jlogreg.diag_hess_th_log_joint, logreg.diag_hess_th_log_joint,
                      Z, TH[2], w)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    full = logreg.hess_th_log_joint(*(torch.from_numpy(a) for a in (Z, TH[2], w)))
    np.testing.assert_allclose(got, torch.diagonal(full).numpy(), atol=ATOL, rtol=0)


def test_grad_z_log_likelihood(inputs):
    """Against the JAX function and the float64 oracle."""
    from oracle import models as om

    Z, TH, _ = inputs
    got, want = _both(jlogreg.grad_z_log_likelihood, logreg.grad_z_log_likelihood, Z, TH)
    assert got.shape == (40, 9, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, om.lr_grad_z_log_likelihood(Z, TH), atol=ATOL, rtol=0)


def test_compute_accuracy_and_predictive_loglik(inputs):
    """Accuracy exactly (the count of right predictions over the same
    signs; the JAX mean of booleans is float32, so the counts are
    compared), the predictive log-likelihood within atol; a score of
    exactly 0 predicts +1."""
    Z, TH, _ = inputs
    Xt, Yt = Z.copy(), np.where(np.arange(40) % 3 == 0, -1.0, 1.0)
    Xt[5] = 0.0                                  # every score 0: predicted +1
    got, want = _both(jlogreg.compute_accuracy, logreg.compute_accuracy, Xt, Yt, TH)
    n = Xt.shape[0] * TH.shape[0]
    assert round(float(got) * n) == round(float(want) * n) and 0.0 < float(got) < 1.0
    got, want = _both(jlogreg.predictive_loglik, logreg.predictive_loglik, Z, TH)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("beta", [0.05, 0.5, 1.0])
def test_beta_gradient_from_autodiff(inputs, beta):
    """The bundle's d/d(beta) (torch.func.jvp) against the JAX bundle's
    (jax.jvp) within rtol 1e-10, and against a central difference."""
    Z, TH, _ = inputs
    got = logreg.bundle().beta_gradient(torch.from_numpy(Z), torch.from_numpy(TH),
                                        torch.tensor(beta, dtype=torch.float64)).numpy()
    want = np.asarray(jlogreg.bundle().beta_gradient(jnp.asarray(Z), jnp.asarray(TH), beta))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    h = 1e-6
    fd = (logreg.beta_likelihood(torch.from_numpy(Z), torch.from_numpy(TH), beta + h)
          - logreg.beta_likelihood(torch.from_numpy(Z), torch.from_numpy(TH), beta - h)) / (2 * h)
    np.testing.assert_allclose(got, fd.numpy(), atol=1e-6)


def test_projections_with_grad(inputs):
    """``project_beta_with_grad`` (the centred beta projection and its
    centred d/d(beta)) and ``project_ll_with_grad`` (the centred
    log-likelihood and data-gradient projections) against the JAX
    projection engine's."""
    from betacores_tpu.ops import projection as jproj
    from betacores_tpu_torch.ops import projection as tproj

    Z, TH, _ = inputs
    jm, tm = jlogreg.bundle(fused=False), logreg.bundle()
    zj, tj, zt, tt = jnp.asarray(Z), jnp.asarray(TH), torch.from_numpy(Z), torch.from_numpy(TH)
    pairs = zip(tproj.project_beta_with_grad(tm, zt, tt, torch.tensor(0.3, dtype=torch.float64)),
                jproj.project_beta_with_grad(jm, zj, tj, 0.3))
    pairs = list(pairs) + list(zip(tproj.project_ll_with_grad(tm, zt, tt),
                                   jproj.project_ll_with_grad(jm, zj, tj)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert np.allclose(pairs[1][0].mean(dim=1).numpy(), 0.0, atol=1e-12)
