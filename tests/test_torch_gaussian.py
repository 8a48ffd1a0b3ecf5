"""The port's known-covariance Gaussian family (betacores_tpu_torch/models/
gaussian.py, its conjugate and prior samplers, the Gaussian metrics and the
generator) against the JAX package's functions on the same numpy inputs, in
float64 (the conftest's x64): every model function to rtol 1e-10 and the
oracle's goldens (oracle/models.py ``gauss_*``), the autodiff beta-gradient
to 1e-8, each sampler's ``from_noise`` under the JAX sampler's own noise to
1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.evaluation import metrics as jmetrics
from betacores_tpu.inference.samplers import (gaussian_conjugate_sampler as jgauss_sampler,
                                              prior_gaussian_sampler as jprior_sampler)
from betacores_tpu.models import gaussian as jg
from betacores_tpu_torch import gen_synthetic_gaussian
from betacores_tpu_torch.evaluation import reverse_forward_kl
from betacores_tpu_torch.inference import (gaussian_conjugate_sampler,
                                           prior_gaussian_sampler)
from betacores_tpu_torch.models import gaussian as tg
from oracle import models as om

torch.set_num_threads(1)

N, D, S = 30, 4, 7
RT = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(D, D))
    Sig = A @ A.T + D * np.eye(D)
    Siginv = np.linalg.inv(Sig)
    return dict(x=rng.normal(size=(N, D)) * 2.0, th=rng.normal(size=(S, D)),
                Sig=Sig, Siginv=Siginv, logdet=float(np.linalg.slogdet(Sig)[1]),
                mu0=rng.normal(size=D), Sig0inv=np.eye(D) * 0.5,
                w=rng.uniform(0.0, 3.0, size=N))


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(a)


def test_model_functions_match_jax_and_oracle(prob):
    p = prob
    x, th, Si, ld = p["x"], p["th"], p["Siginv"], p["logdet"]
    pairs = [
        (tg.pairwise_mahalanobis_sq(t(x), t(th), t(Si)),
         jg.pairwise_mahalanobis_sq(j(x), j(th), j(Si)), om.gauss_maha_sq(x, th, Si)),
        (tg.log_likelihood(t(x), t(th), t(Si), ld),
         jg.log_likelihood(j(x), j(th), j(Si), ld), om.gauss_log_likelihood(x, th, Si, ld)),
        (tg.grad_x_log_likelihood(t(x), t(th), t(Si)),
         jg.grad_x_log_likelihood(j(x), j(th), j(Si)),
         om.gauss_grad_x_log_likelihood(x, th, Si)),
        (tg.beta_likelihood(t(x), t(th), 0.3, t(Si), ld),
         jg.beta_likelihood(j(x), j(th), 0.3, j(Si), ld),
         om.gauss_beta_likelihood(x, th, 0.3, Si)),
        (tg.beta_gradient_reference(t(x), t(th), 0.3, t(Si), ld),
         jg.beta_gradient_reference(j(x), j(th), 0.3, j(Si), ld), None),
    ]
    for got, want, gold in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
        if gold is not None:
            np.testing.assert_allclose(got.numpy(), gold, rtol=1e-9, atol=1e-9)


def test_beta_gradient_matches_jax_autodiff_and_oracle(prob):
    p = prob
    tb = tg.bundle(t(p["Siginv"]), p["logdet"])
    jb = jg.bundle(j(p["Siginv"]), p["logdet"])
    got = tb.beta_gradient(t(p["x"]), t(p["th"]), torch.tensor(0.3, dtype=torch.float64))
    want = np.asarray(jb.beta_gradient(j(p["x"]), j(p["th"]), 0.3))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-10)
    gold = om.gauss_beta_gradient(p["x"], p["th"], 0.3, p["Siginv"])
    np.testing.assert_allclose(got.numpy(), gold, rtol=1e-8, atol=1e-10)
    # the bundle's other fields are the module's functions; fused is ignored
    for name in ("log_likelihood", "grad_z_log_likelihood"):
        np.testing.assert_allclose(getattr(tb, name)(t(p["x"]), t(p["th"])).numpy(),
                                   np.asarray(getattr(jb, name)(j(p["x"]), j(p["th"]))), **RT)
    assert tg.bundle(t(p["Siginv"]), p["logdet"], fused=True).fused_ll_projection is None


def test_weighted_post_matches_jax_and_oracle(prob):
    p = prob
    got = tg.weighted_post(t(p["mu0"]), t(p["Sig0inv"]), t(p["Siginv"]), t(p["x"]), t(p["w"]))
    want = jg.weighted_post(j(p["mu0"]), j(p["Sig0inv"]), j(p["Siginv"]), j(p["x"]), j(p["w"]))
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), **RT)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol), **RT)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), **RT)
    np.testing.assert_allclose(got.prec.numpy(), np.asarray(want.prec), **RT)
    mu_o, Sigp_o = om.gauss_weighted_post(p["mu0"], p["Sig0inv"], p["Siginv"], p["x"], p["w"])
    np.testing.assert_allclose(got.mu.numpy(), mu_o, rtol=1e-9)
    np.testing.assert_allclose(got.cov.numpy(), Sigp_o, rtol=1e-9, atol=1e-12)


def test_gaussian_kl_and_metrics_match_jax_and_oracle(prob):
    p = prob
    args = [(t(p["mu0"]), t(p["Sig0inv"]), t(p["Siginv"])),
            (j(p["mu0"]), j(p["Sig0inv"]), j(p["Siginv"]))]
    tw = tg.weighted_post(*args[0], t(p["x"][:10]), t(p["w"][:10]))
    tf = tg.weighted_post(*args[0], t(p["x"]), t(p["w"]))
    jw = jg.weighted_post(*args[1], j(p["x"][:10]), j(p["w"][:10]))
    jf = jg.weighted_post(*args[1], j(p["x"]), j(p["w"]))
    got = [float(v) for v in reverse_forward_kl(tw, tf)]
    want = [float(v) for v in jmetrics.reverse_forward_kl(jw, jf)]
    np.testing.assert_allclose(got, want, rtol=1e-10)
    gold = om.gaussian_KL(np.asarray(jw.mu), np.asarray(jw.cov), np.asarray(jf.mu),
                          np.asarray(jf.prec))
    np.testing.assert_allclose(got[0], gold, rtol=1e-9)
    assert got[0] > 0 and got[1] > 0
    # the JAX posterior carried across gives the same KL
    carried = tg.posterior_from_numpy({k: np.asarray(v) for k, v in jw._asdict().items()},
                                      device="cpu")
    np.testing.assert_allclose(float(reverse_forward_kl(carried, tf)[0]), want[0], rtol=1e-10)


def test_sample_gaussian_prec_from_noise_matches_jax(prob):
    p = prob
    post_t = tg.weighted_post(t(p["mu0"]), t(p["Sig0inv"]), t(p["Siginv"]), t(p["x"]), t(p["w"]))
    post_j = jg.weighted_post(j(p["mu0"]), j(p["Sig0inv"]), j(p["Siginv"]), j(p["x"]), j(p["w"]))
    z = np.random.default_rng(3).normal(size=(50, D))
    np.testing.assert_allclose(tg.sample_gaussian_prec_from_noise(post_t, t(z)).numpy(),
                               np.asarray(jg.sample_gaussian_prec_from_noise(post_j, j(z))), **RT)
    # the port's own draws have the posterior's moments
    draws = tg.sample_gaussian_prec(torch.Generator().manual_seed(0), post_t, 40_000).numpy()
    cov = post_t.cov.numpy()
    np.testing.assert_allclose(draws.mean(0), post_t.mu.numpy(), atol=4 * np.sqrt(cov.diagonal().max() / 40_000))
    np.testing.assert_allclose(np.cov(draws.T), cov, rtol=0.05, atol=0.02 * np.abs(cov).max())


@pytest.mark.parametrize("data_dtype", [np.float64, np.float32])
def test_conjugate_sampler_from_noise_matches_jax(prob, data_dtype):
    """from_noise under the JAX sampler's own noise; the noise is drawn in
    the dtype the posterior computes in (a float64 prior over float32 rows
    promotes, as the JAX ``draw_noise`` reads it off the posterior). Over
    float32 rows the port promotes the rows before summing them, where the
    JAX function sums in float32 and then promotes: that case holds to
    float32's rounding."""
    p = prob
    x, w = p["x"].astype(data_dtype), p["w"].astype(data_dtype)
    js = jgauss_sampler(j(p["mu0"]), j(p["Sig0inv"]), j(p["Siginv"]))
    ts = gaussian_conjugate_sampler(t(p["mu0"]), t(p["Sig0inv"]), t(p["Siginv"]))
    aux = np.zeros(D)
    z = js.draw_noise(jax.random.PRNGKey(2), 60, j(w), j(x), j(aux))
    want, _ = js.from_noise(z, j(w), j(x), j(aux))
    got, got_aux = ts.from_noise(t(np.asarray(z)), t(w), t(x), t(aux))
    tol = RT if data_dtype == np.float64 else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert torch.equal(got_aux, t(aux))
    tz = ts.draw_noise(torch.Generator().manual_seed(0), 60, t(w), t(x), t(aux))
    assert tz.shape == (60, D) and tz.dtype == torch.float64 == got.dtype
    assert np.asarray(z).dtype == np.float64
    # the composition is draw, then transform
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    a, _ = ts(g1, 60, t(w), t(x), t(aux))
    b, _ = ts.from_noise(ts.draw_noise(g2, 60, t(w), t(x), t(aux)), t(w), t(x), t(aux))
    assert torch.equal(a, b)


def test_prior_gaussian_sampler_matches_jax(prob):
    """The port's noise split of the reference's one-call prior sampler:
    the JAX sampler's z through ``from_noise`` gives its samples."""
    p = prob
    LSig = np.linalg.cholesky(p["Sig"])
    key = jax.random.PRNGKey(4)
    want, _ = jprior_sampler(j(p["mu0"]), j(LSig))(key, 25, None, None, None)
    z = jax.random.normal(key, (25, D), dtype=jnp.float64)
    ts = prior_gaussian_sampler(t(p["mu0"]), t(LSig))
    got, _ = ts.from_noise(t(np.asarray(z)), None, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
    pts = torch.zeros(3, D, dtype=torch.float32)
    zz = ts.draw_noise(torch.Generator().manual_seed(0), 25, pts[:, 0], pts, None)
    assert zz.shape == (25, D) and zz.dtype == torch.float64


def test_gen_synthetic_gaussian_shapes_and_moments():
    gen = torch.Generator().manual_seed(0)
    N_g, d, scale = 5000, 6, 500.0
    X, Xc, Sig = gen_synthetic_gaussian(gen, N=N_g, d=d, sig_scale=scale)
    n_out = N_g // 50 * 2 + N_g // 10
    assert X.shape == (N_g, d) and Xc.shape == (N_g + n_out, d)
    assert X.dtype == Xc.dtype == Sig.dtype == torch.float32
    assert torch.equal(Xc[:N_g], X) and torch.equal(Sig, scale * torch.eye(d))
    assert abs(float(X.mean())) < 1.0 and abs(float(X.var()) / scale - 1.0) < 0.05
    o1 = Xc[N_g:N_g + N_g // 50]
    o2 = Xc[N_g + N_g // 50:N_g + 2 * (N_g // 50)]
    o3 = Xc[N_g + 2 * (N_g // 50):]
    assert abs(float(o1.mean()) - 200.0) < 3.0 and abs(float(o2.mean()) - 150.0) < 2.0
    assert abs(float(o3.var()) / (10 * scale) - 1.0) < 0.1
    again = gen_synthetic_gaussian(torch.Generator().manual_seed(0), N=N_g, d=d, sig_scale=scale)
    assert torch.equal(again[1], Xc)
