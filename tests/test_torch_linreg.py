"""The port's Bayesian linear regression (betacores_tpu_torch/models/linreg.py,
``linreg_conjugate_sampler``, ``regression_rmse_nll`` and the generator)
against the JAX package's functions on the same numpy inputs, in float64:
every model function to rtol 1e-10 and the oracle's goldens
(oracle/models.py ``linreg_*``, whose expanded residual the factored form
matches in float64), the autodiff beta-gradient to 1e-8, ``from_noise``
under the JAX sampler's noise to 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.evaluation import metrics as jmetrics
from betacores_tpu.inference.samplers import linreg_conjugate_sampler as jsampler
from betacores_tpu.models import linreg as jl
from betacores_tpu_torch import gen_synthetic_linreg
from betacores_tpu_torch.evaluation import regression_rmse_nll
from betacores_tpu_torch.inference import linreg_conjugate_sampler
from betacores_tpu_torch.models import linreg as tl
from oracle import models as om

torch.set_num_threads(1)

N, D, S, SIGSQ = 40, 3, 6, 0.7
RT = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(N, D))
    w_true = rng.normal(size=D)
    y = X @ w_true + 0.5 * rng.normal(size=N)
    return dict(z=np.c_[X, y], th=w_true + 0.2 * rng.normal(size=(S, D)),
                mu0=rng.normal(size=D), Sig0inv=np.eye(D) * 0.3,
                w=rng.uniform(0.0, 2.0, size=N))


def t(a):
    return torch.from_numpy(np.array(a))


def test_model_functions_match_jax_and_oracle(prob):
    z, th = prob["z"], prob["th"]
    for got, want, gold in [
            (tl.log_likelihood(t(z), t(th), SIGSQ), jl.log_likelihood(z, th, SIGSQ),
             om.linreg_log_likelihood(z, th, SIGSQ)),
            (tl.beta_likelihood(t(z), t(th), 0.4, SIGSQ), jl.beta_likelihood(z, th, 0.4, SIGSQ),
             om.linreg_beta_likelihood(z, th, 0.4, SIGSQ)),
            (tl.grad_z_log_likelihood(t(z), t(th), SIGSQ),
             jl.grad_z_log_likelihood(z, th, SIGSQ), None)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
        if gold is not None:
            np.testing.assert_allclose(got.numpy(), gold, rtol=1e-9, atol=1e-9)
    # d/dy has the true sign: -(y - x.th)/sigsq
    g = tl.grad_z_log_likelihood(t(z), t(th), SIGSQ).numpy()
    np.testing.assert_allclose(g[:, :, -1], -(z[:, -1:] - z[:, :-1] @ th.T) / SIGSQ, rtol=1e-12)


def test_beta_gradient_matches_jax_autodiff(prob):
    z, th = prob["z"], prob["th"]
    got = tl.bundle(SIGSQ).beta_gradient(t(z), t(th), torch.tensor(0.4, dtype=torch.float64))
    want = jl.bundle(SIGSQ).beta_gradient(jnp.asarray(z), jnp.asarray(th), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


def test_weighted_post_matches_jax_and_oracle(prob):
    p = prob
    got = tl.weighted_post(t(p["mu0"]), t(p["Sig0inv"]), SIGSQ, t(p["z"]), t(p["w"]))
    want = jl.weighted_post(jnp.asarray(p["mu0"]), jnp.asarray(p["Sig0inv"]), SIGSQ,
                            jnp.asarray(p["z"]), jnp.asarray(p["w"]))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), **RT)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol), **RT)
    mu_o, Sigp_o = om.linreg_weighted_post(p["mu0"], p["Sig0inv"], SIGSQ, p["z"], p["w"])
    np.testing.assert_allclose(got.mu.numpy(), mu_o, rtol=1e-9)
    np.testing.assert_allclose(got.cov.numpy(), Sigp_o, rtol=1e-9, atol=1e-12)


def test_conjugate_sampler_from_noise_matches_jax(prob):
    p = prob
    js = jsampler(jnp.asarray(p["mu0"]), jnp.asarray(p["Sig0inv"]), SIGSQ)
    ts = linreg_conjugate_sampler(t(p["mu0"]), t(p["Sig0inv"]), SIGSQ)
    aux = np.zeros(D)
    z = js.draw_noise(jax.random.PRNGKey(6), 40, p["w"], p["z"], aux)
    want, _ = js.from_noise(z, p["w"], p["z"], aux)
    got, _ = ts.from_noise(t(np.asarray(z)), t(p["w"]), t(p["z"]), t(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
    tz = ts.draw_noise(torch.Generator().manual_seed(0), 40, t(p["w"]), t(p["z"]), t(aux))
    assert tz.shape == (40, D) and tz.dtype == torch.float64


def test_regression_rmse_nll_matches_jax(prob):
    z, th = prob["z"], prob["th"]
    got = regression_rmse_nll(t(z[:, :-1]), t(z[:, -1:]), t(th), SIGSQ)
    want = jmetrics.regression_rmse_nll(z[:, :-1], z[:, -1:], th, SIGSQ)
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-10)


def test_gen_synthetic_linreg_shapes_and_moments():
    X, y, w = gen_synthetic_linreg(torch.Generator().manual_seed(0), N=4000, D=12,
                                   noise_std=0.1)
    assert X.shape == (4000, 13) and y.shape == (4000, 1) and w.shape == (13,)
    assert X.dtype == y.dtype == w.dtype == torch.float32
    assert torch.equal(X[:, -1], torch.ones(4000))
    assert abs(float(w.mean()) - 10.0) < 1.5
    resid = (y[:, 0] - X @ w).numpy()
    assert abs(resid.std() - 0.1) < 0.01 and abs(resid.mean()) < 0.01
    assert abs(float(X[:, :-1].std()) - 1.0) < 0.05
