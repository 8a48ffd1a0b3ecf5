"""The port's unknown-covariance Gaussian (betacores_tpu_torch/models/mvn.py:
the packed likelihoods, the weighted NIW update, the NIW densities, KL and
predictive, and the NIW sampler) against the JAX package's functions on the
same numpy inputs, in float64: every function to rtol 1e-10, the autodiff
beta-gradient to 1e-8, ``sample_niw_from_draws`` under the draws that the
JAX ``sample_niw`` takes from its key to 1e-10. The two packages' gamma
streams differ, so the port's own draws are held by the exact NIW moments,
as tests/test_mvn.py holds the JAX sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.models import mvn as jm
from betacores_tpu_torch.models import mvn as tm

torch.set_num_threads(1)

D, N, S = 3, 25, 5
RT = dict(rtol=1e-10, atol=1e-12)


def t(a):
    return torch.from_numpy(np.array(a))


def _post(module, post_np, conv):
    return module.NIWPosterior(*(conv(post_np[k]) for k in ("mu", "kappa", "Psi", "nu")))


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(21)
    Ls = []
    for _ in range(S):
        A = rng.normal(size=(D, D))
        Ls.append(np.linalg.cholesky(A @ A.T + D * np.eye(D)))
    th = np.concatenate([rng.normal(size=(S, D)), np.stack(Ls).reshape(S, D * D)], axis=1)
    post = dict(mu=np.array([1.0, -0.5, 0.2]), kappa=np.array(4.0),
                Psi=np.array([[2.0, 0.3, 0.1], [0.3, 1.5, -0.2], [0.1, -0.2, 1.0]]),
                nu=np.array(9.0))
    q = dict(mu=np.array([0.2, 0.1, 0.0]), kappa=np.array(2.0),
             Psi=np.array([[1.0, -0.2, 0.0], [-0.2, 2.5, 0.1], [0.0, 0.1, 1.3]]),
             nu=np.array(7.0))
    return dict(z=rng.normal(size=(N, D)) * 1.5, th=th, w=rng.uniform(0.0, 3.0, size=N),
                prior=(np.zeros(D), 1.0, 2.0 * np.eye(D), D + 4.0), post=post, q=q)


def test_likelihoods_match_jax(prob):
    z, th = prob["z"], prob["th"]
    mu, L = tm.unpack(t(th), D)
    assert torch.equal(tm.pack(mu, L), t(th))
    for name in ("log_likelihood", "grad_z_log_likelihood"):
        np.testing.assert_allclose(getattr(tm, name)(t(z), t(th)).numpy(),
                                   np.asarray(getattr(jm, name)(z, th)), **RT, err_msg=name)
    np.testing.assert_allclose(tm.beta_likelihood(t(z), t(th), 0.5).numpy(),
                               np.asarray(jm.beta_likelihood(z, th, 0.5)), **RT)
    got = tm.bundle(D).beta_gradient(t(z), t(th), torch.tensor(0.5, dtype=torch.float64))
    want = jm.bundle(D).beta_gradient(jnp.asarray(z), jnp.asarray(th), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_weighted_post_matches_jax(prob, zero_weights):
    """The weighted NIW update; all-zero weights give the prior."""
    mu0, kappa0, Psi0, nu0 = prob["prior"]
    w = np.zeros(N) if zero_weights else prob["w"]
    got = tm.weighted_post(t(mu0), kappa0, t(Psi0), nu0, t(prob["z"]), t(w))
    want = jm.weighted_post(jnp.asarray(mu0), kappa0, jnp.asarray(Psi0), nu0,
                            jnp.asarray(prob["z"]), jnp.asarray(w))
    for g, v in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(v), **RT)
    if zero_weights:
        np.testing.assert_allclose(got.mu.numpy(), mu0, atol=1e-12)
        np.testing.assert_allclose(got.Psi.numpy(), Psi0, atol=1e-12)


def test_densities_kl_and_predictive_match_jax(prob):
    p_np, q_np = prob["post"], prob["q"]
    tp, tq = _post(tm, p_np, t), _post(tm, q_np, t)
    jp, jq = _post(jm, p_np, jnp.asarray), _post(jm, q_np, jnp.asarray)
    for row in prob["th"][:3]:
        np.testing.assert_allclose(float(tm.niw_logpdf(t(row), tp)),
                                   float(jm.niw_logpdf(jnp.asarray(row), jp)), rtol=1e-10)
    np.testing.assert_allclose(float(tm.niw_kl(tp, tq)), float(jm.niw_kl(jp, jq)), rtol=1e-10)
    np.testing.assert_allclose(float(tm.niw_kl(tq, tp)), float(jm.niw_kl(jq, jp)), rtol=1e-10)
    assert abs(float(tm.niw_kl(tp, tp))) < 1e-10
    np.testing.assert_allclose(tm.predictive_logpdf(t(prob["z"]), tp).numpy(),
                               np.asarray(jm.predictive_logpdf(jnp.asarray(prob["z"]), jp)), **RT)
    # the JAX posterior carried across
    carried = tm.posterior_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()},
                                      device="cpu")
    np.testing.assert_allclose(float(tm.niw_kl(carried, tq)), float(jm.niw_kl(jp, jq)),
                               rtol=1e-10)


def _jax_niw_draws(key, post, n):
    """The draws JAX's ``sample_niw(key, post, n)`` takes, in its order:
    (standard gamma of shape 0.5 (nu - i), subdiagonal normals, the mean's
    normals)."""
    d = post.mu.shape[0]
    k_diag, k_off, k_mu = jax.random.split(key, 3)
    df = post.nu - jnp.arange(d, dtype=post.mu.dtype)
    gam = jax.random.gamma(k_diag, 0.5 * df[None, :].repeat(n, 0))
    off = jax.random.normal(k_off, (n, d, d), dtype=post.mu.dtype)
    xi = jax.random.normal(k_mu, (n, d), dtype=post.mu.dtype)
    return [np.asarray(a) for a in (gam, off, xi)]


def test_sample_niw_from_draws_matches_jax_under_its_draws(prob):
    p_np = prob["post"]
    jp = _post(jm, p_np, jnp.asarray)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jm.sample_niw(key, jp, 64))
    got = tm.sample_niw_from_draws(_post(tm, p_np, t), *map(t, _jax_niw_draws(key, jp, 64)))
    np.testing.assert_allclose(got.numpy(), want, **RT)


def test_niw_sampler_matches_jax_sampler_under_its_draws(prob):
    """The sampler: the weighted update of the prior, then the transform;
    under the JAX sampler's draws it gives the JAX sampler's samples."""
    mu0, kappa0, Psi0, nu0 = prob["prior"]
    z, w = prob["z"], prob["w"]
    js = jm.mvn_niw_sampler(jnp.asarray(mu0), kappa0, jnp.asarray(Psi0), nu0)
    ts = tm.mvn_niw_sampler(t(mu0), kappa0, t(Psi0), nu0)
    key = jax.random.PRNGKey(3)
    want, _ = js(key, 32, jnp.asarray(w), jnp.asarray(z), jnp.zeros(D + D * D))
    jpost = jm.weighted_post(jnp.asarray(mu0), kappa0, jnp.asarray(Psi0), nu0,
                             jnp.asarray(z), jnp.asarray(w))
    tpost = ts.posterior(t(w), t(z))
    got = tm.sample_niw_from_draws(tpost, *map(t, _jax_niw_draws(key, jpost, 32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RT)
    # its own draws: shape, dtype, the aux passed through
    aux = torch.zeros(D + D * D, dtype=torch.float64)
    th, aux_out = ts(torch.Generator().manual_seed(0), 32, t(w), t(z), aux)
    assert th.shape == (32, D + D * D) and th.dtype == torch.float64 and aux_out is aux
    assert not hasattr(ts, "draw_noise") and not hasattr(ts, "from_noise")


def test_niw_sampler_moments(prob):
    """The port's own NIW draws: E[Lambda] = nu Psi^-1, E[Sigma] =
    Psi / (nu - d - 1), E[mu] = mu_n, Cov[mu] = Psi / (kappa (nu - d - 1)),
    at tests/test_mvn.py's tolerances."""
    p_np = dict(prob["post"], nu=np.array(13.0))
    post = _post(tm, p_np, t)
    n = 40_000
    mu, L = tm.unpack(tm.sample_niw(torch.Generator().manual_seed(0), post, n), D)
    mu, L = mu.numpy(), L.numpy()
    Lam = L @ np.transpose(L, (0, 2, 1))
    nu, Psi, kappa = float(p_np["nu"]), p_np["Psi"], float(p_np["kappa"])
    ELam = nu * np.linalg.inv(Psi)
    np.testing.assert_allclose(Lam.mean(0), ELam, rtol=0.05, atol=0.02 * np.abs(ELam).max())
    ESig = Psi / (nu - D - 1)
    np.testing.assert_allclose(np.linalg.inv(Lam).mean(0), ESig, rtol=0.05,
                               atol=0.02 * np.abs(ESig).max())
    np.testing.assert_allclose(mu.mean(0), p_np["mu"], atol=0.02)
    np.testing.assert_allclose(np.cov(mu.T), Psi / (kappa * (nu - D - 1)), rtol=0.08, atol=5e-4)
