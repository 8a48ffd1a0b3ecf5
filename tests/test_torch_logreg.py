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
