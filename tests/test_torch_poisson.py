"""The port's Poisson regression (betacores_tpu_torch/models/poisson.py, its
Laplace samplers and the generator) against the JAX package's functions on
the same numpy inputs, in float64: every model function to rtol 1e-10 (the
beta-likelihood with both mass forms), the autodiff beta-gradient to 1e-8,
the Laplace samplers' ``from_noise`` under the JAX samplers' noise to
1e-10; the row-chunked exact mass equal to one chunk; and the float32
stability at extreme eta that tests/test_poisson.py holds the JAX module
to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference.samplers import poisson_laplace_sampler as jsampler
from betacores_tpu.models import poisson as jp
from betacores_tpu_torch import gen_synthetic_poisson
from betacores_tpu_torch.inference import poisson_laplace_sampler
from betacores_tpu_torch.models import poisson as tp

torch.set_num_threads(1)

N, D, S = 50, 4, 6
RT = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(12)
    X = np.c_[rng.normal(size=(N, D - 1)), np.ones(N)]
    th = 0.5 * rng.normal(size=D)
    y = rng.poisson(np.logaddexp(0.0, X @ th)).astype(float)
    y[:4] += 30.0                                  # a few large counts
    return dict(z=np.c_[X, y], th=th + 0.3 * rng.normal(size=(S, D)),
                w=rng.uniform(0.0, 2.0, size=N))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("gaussian_mass", [False, True])
def test_likelihoods_match_jax(prob, gaussian_mass):
    z, th = prob["z"], prob["th"]
    np.testing.assert_allclose(tp.log_likelihood(t(z), t(th)).numpy(),
                               np.asarray(jp.log_likelihood(z, th)), **RT)
    np.testing.assert_allclose(tp.grad_z_log_likelihood(t(z), t(th)).numpy(),
                               np.asarray(jp.grad_z_log_likelihood(z, th)), **RT)
    for beta in (0.05, 0.4):
        got = tp.beta_likelihood(t(z), t(th), beta, k_max=80, gaussian_mass=gaussian_mass)
        want = jp.beta_likelihood(z, th, beta, k_max=80, gaussian_mass=gaussian_mass)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
    tb = tp.bundle(k_max=80, gaussian_mass=gaussian_mass, fused=True)
    jb = jp.bundle(k_max=80, gaussian_mass=gaussian_mass)
    got = tb.beta_gradient(t(z), t(th), torch.tensor(0.4, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), np.asarray(jb.beta_gradient(z, th, 0.4)),
                               rtol=1e-8, atol=1e-10)
    assert tb.fused_beta_projection is None


def test_chunked_mass_equals_one_chunk(prob, monkeypatch):
    """The exact mass term in several row chunks (a budget of 7 rows' worth
    of elements, so 50 rows take 8 chunks) equals the one-chunk result, and
    so does its beta-gradient."""
    z, th = t(prob["z"]), t(prob["th"])
    beta = torch.tensor(0.3, dtype=torch.float64)
    one = tp.beta_likelihood(z, th, beta, k_max=64)
    g_one = tp.bundle(k_max=64).beta_gradient(z, th, beta)
    monkeypatch.setattr(tp, "MASS_CHUNK_ELEMENTS", 7 * S * 65)
    assert tp.MASS_CHUNK_ELEMENTS // (S * 65) == 7
    chunked = tp.beta_likelihood(z, th, beta, k_max=64)
    assert torch.equal(chunked, one)
    assert torch.equal(tp.bundle(k_max=64).beta_gradient(z, th, beta), g_one)


def test_joint_functions_match_jax(prob):
    z, th, w = prob["z"], prob["th"], prob["w"]
    th0 = th[0]
    for name in ("log_joint", "grad_th_log_joint", "hess_th_log_joint",
                 "diag_hess_th_log_joint"):
        np.testing.assert_allclose(getattr(tp, name)(t(z), t(th0), t(w)).numpy(),
                                   np.asarray(getattr(jp, name)(z, th0, w)), **RT,
                                   err_msg=name)
    # a batch of candidates, as the Newton line search evaluates them
    batch = tp.log_joint(t(z), t(th), t(w)).numpy()
    np.testing.assert_allclose(batch, [float(jp.log_joint(z, r, w)) for r in th], **RT)
    np.testing.assert_allclose(float(tp.predictive_loglik(t(z), t(th))),
                               float(jp.predictive_loglik(z, th)), rtol=1e-10)


@pytest.mark.parametrize("diag", [False, True])
def test_laplace_sampler_from_noise_matches_jax(prob, diag):
    z, w = prob["z"], prob["w"]
    js, ts = jsampler(diag=diag), poisson_laplace_sampler(diag=diag)
    aux = np.zeros(D)
    noise = js.draw_noise(jax.random.PRNGKey(1), 30, w, z, aux)
    want, want_mu = js.from_noise(noise, w, z, aux)
    got, got_mu = ts.from_noise(t(np.asarray(noise)), t(w), t(z), t(aux))
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(want_mu), **RT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
    assert ts.n_newton == 10 and not hasattr(ts, "fit_inv")
    # the lagged-refit split: fit once, transform the noise
    lap = ts.fit(t(w), t(z), t(aux))
    np.testing.assert_allclose(ts.from_fit(lap, t(np.asarray(noise))).numpy(),
                               np.asarray(want), **RT)
    assert torch.equal(ts.fit_aux(lap), lap.mu)


def test_extreme_eta_stability_f32():
    """Rates that underflow in float32 give no inf from y/f, and
    log softplus(eta) -> eta below -30 (tests/test_poisson.py's case)."""
    z = torch.tensor([[-50.0, 1.0, 7.0], [50.0, 1.0, 3.0]])
    th = torch.tensor([3.0, 0.0])                       # eta = -150, +150
    wts = torch.ones(2)
    for fn in (tp.log_joint, tp.grad_th_log_joint, tp.hess_th_log_joint,
               tp.diag_hess_th_log_joint):
        v = fn(z, th, wts)
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), fn.__name__
    for v in (tp.log_likelihood(z, th[None]), tp.grad_z_log_likelihood(z, th[None]),
              tp.beta_likelihood(z, th[None], 0.3)):
        assert bool(torch.isfinite(v).all())
    assert float(tp._log_softplus(torch.tensor(-150.0))) == -150.0
    c = float(7.0 * tp._sig_over_f(torch.tensor(-150.0)))
    assert abs(c - 7.0) < 1e-3


def test_gen_synthetic_poisson_shapes_and_moments():
    X, y, Z, th = gen_synthetic_poisson(torch.Generator().manual_seed(0), N=20_000, d=5)
    assert X.shape == (20_000, 5) and y.shape == (20_000,) and Z.shape == (20_000, 6)
    assert th.shape == (5,) and Z.dtype == torch.float32
    assert torch.equal(X[:, -1], torch.ones(20_000)) and torch.equal(Z[:, -1], y)
    assert bool((y >= 0).all()) and torch.equal(y, y.round())
    f = torch.nn.functional.softplus(X @ th)
    # Poisson: E[y - f] = 0 and Var[y - f] = E[f]
    r = (y - f).double()
    assert abs(float(r.mean())) < 4 * float(f.mean().sqrt()) / np.sqrt(20_000)
    assert abs(float(r.var()) / float(f.mean()) - 1.0) < 0.05
