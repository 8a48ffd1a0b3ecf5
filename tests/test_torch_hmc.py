"""The port's HMC (betacores_tpu_torch/inference/hmc.py) against the JAX
package's (betacores_tpu/inference/hmc.py) under the JAX draws, rebuilt
from its keys (tests/torch_jax_mcmc.py), in float64 on small targets:
one trajectory to rtol 1e-10, whole adaptive runs (d = 3, 40 + 40
iterations, L_max = 8) to rtol 1e-8 (the chains batch their products, so
sums round in another order, and 80 dependent iterations carry that
along); and the port's own generator against the target's moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference import hmc as jhmc
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu.models import poisson as jpoisson
from betacores_tpu_torch.inference import hmc as thmc
from betacores_tpu_torch.models import logreg as tlogreg
from tests.torch_jax_mcmc import hmc_draws, hmc_iteration_draws

RTOL = 1e-8
CFG = jhmc.HMCConfig(n_samples=40, n_warmup=40, L_max=8)
D = 3


def _logreg_data(N=30, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = np.where(rng.uniform(size=N) < 1 / (1 + np.exp(-X @ np.ones(D))), 1.0, -1.0)
    return y[:, None] * X, rng.uniform(0.5, 2.0, size=N)


def _poisson_data(N=30, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = rng.poisson(np.log1p(np.exp(X @ np.full(D, 0.5))))
    return np.concatenate([X, y[:, None].astype(float)], axis=1), rng.uniform(0.5, 2.0, size=N)


def _targets():
    Z, w = _logreg_data()
    Zt, wt = torch.from_numpy(Z), torch.from_numpy(w)
    Zj, wj = jnp.asarray(Z), jnp.asarray(w)
    return (lambda th: tlogreg.log_joint(Zt, th, wt),
            lambda th: jlogreg.log_joint(Zj, th, wj))


def _close(got, want, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol,
                               err_msg=what)


def _same_run(got, want, rtol=RTOL):
    (s, st), (sj, stj) = got, want
    _close(s, sj, rtol, "samples")
    for k in ("step_size", "accept_stat", "inv_mass", "warmup_accept"):
        _close(st[k], stj[k], rtol, k)


def test_leapfrog_trajectory_matches_jax():
    """One transition of three chains (step sizes that accept and that
    reject) against the JAX trajectory of each chain's key."""
    tlp, jlp = _targets()
    keys = jax.random.split(jax.random.key(3), 3)
    z, L, j, u = (np.array(x) for x in hmc_iteration_draws(keys, D, 16))
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(3, D)) * 0.3
    eps = np.asarray([0.05, 0.4, 2.5])
    inv_mass = rng.uniform(0.5, 2.0, size=(3, D))
    got = thmc._leapfrog_trajectory(
        (torch.from_numpy(z), torch.from_numpy(j).long(), torch.from_numpy(u)),
        thmc.make_precise_logprob_and_grad(tlp), torch.from_numpy(theta),
        torch.from_numpy(eps), torch.from_numpy(L).long(), 16, torch.from_numpy(inv_mass))
    jlpg = jhmc.make_precise_logprob_and_grad(jlp)
    for c in range(3):
        k_traj, _ = jax.random.split(keys[c])
        th, astat = jhmc._leapfrog_trajectory(k_traj, jlpg, jnp.asarray(theta[c]),
                                              jnp.asarray(eps[c]), jnp.asarray(L[c]), 16,
                                              jnp.asarray(inv_mass[c]))
        _close(got[0][c], th, 1e-10, f"theta, chain {c}")
        _close(got[1][c], astat, 1e-10, f"accept, chain {c}")
    # one chain accepts nearly always, one mostly rejects
    assert float(got[1].min()) < 0.5 < float(got[1].max()) <= 1.0


def test_run_chains_matches_jax():
    tlp, jlp = _targets()
    key = jax.random.key(7)
    theta0 = np.zeros(D)
    want = jhmc.run_chains(key, jlp, jnp.asarray(theta0), 2, CFG)
    got = thmc.run_chains(hmc_draws(key, 2, D, CFG), tlp, torch.from_numpy(theta0), 2, CFG)
    assert got[0].shape == (2, CFG.n_samples, D)
    _same_run(got, want)


def test_hmc_sample_matches_jax():
    tlp, jlp = _targets()
    key = jax.random.key(8)
    theta0 = np.full(D, 0.2)
    want = jhmc.hmc_sample(key, jlp, jnp.asarray(theta0), CFG)
    got = thmc.hmc_sample(hmc_draws(key, 1, D, CFG, chains=False), tlp,
                          torch.from_numpy(theta0), CFG)
    assert got[0].shape == (CFG.n_samples, D) and got[1]["step_size"].dim() == 0
    _same_run(got, want)


def test_run_chains_init_jitter():
    """The chains start at theta0 + 0.1 N(0, I), the JAX normals of
    fold_in(key, 99) when injected; the generator draws them first."""
    key, theta0 = jax.random.key(11), np.asarray([0.5, -1.0, 2.0])
    draws = hmc_draws(key, 4, D, CFG)
    want = jnp.asarray(theta0) + 0.1 * jax.random.normal(jax.random.fold_in(key, 99), (4, D),
                                                         dtype=jnp.float64)
    _close(thmc._chain_inits(torch.from_numpy(theta0), draws), want, 1e-15)
    gen = torch.Generator().manual_seed(5)
    first = torch.randn((4, D), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    assert torch.equal(thmc.draw_hmc(gen, 4, D, CFG, torch.float64).init, first)


def test_generator_draws_are_in_range():
    d = thmc.draw_hmc(torch.Generator().manual_seed(0), 3, D, CFG._replace(L_max=4),
                      torch.float64)
    for ph, n in zip(d.phases, thmc.phase_lengths(CFG)):
        assert ph.z.shape == (n, 3, D) and ph.u.shape == (n, 3, 4)
        assert int(ph.L.min()) >= 1 and int(ph.L.max()) <= 4
        assert int(ph.j.min()) >= 0 and bool((ph.j <= ph.L).all())


@pytest.mark.parametrize("model", ["logreg", "poisson"])
def test_weighted_runners_match_jax_and_padding_is_inert(model):
    """The weighted runners against the JAX ones; the port's coreset is
    padded with zero-weight rows of garbage, which change nothing."""
    Z, w = _logreg_data() if model == "logreg" else _poisson_data()
    rng = np.random.default_rng(9)
    Zp = np.concatenate([Z, rng.normal(size=(5, Z.shape[1])) * 50])
    wp = np.concatenate([w, np.zeros(5)])
    run_j = (jhmc.run_chains_weighted_logreg if model == "logreg"
             else jhmc.run_chains_weighted_poisson)
    run_t = (thmc.run_chains_weighted_logreg if model == "logreg"
             else thmc.run_chains_weighted_poisson)
    key, theta0 = jax.random.key(12), np.zeros(D)
    want = run_j(key, jnp.asarray(Z), jnp.asarray(w), jnp.asarray(theta0), 2, CFG)
    draws = hmc_draws(key, 2, D, CFG)
    got = run_t(draws, torch.from_numpy(Zp), torch.from_numpy(wp), torch.from_numpy(theta0), 2,
                CFG)
    _same_run(got, want)
    # the cached runner serves the unpadded shape too
    again = run_t(draws, torch.from_numpy(Z), torch.from_numpy(w), torch.from_numpy(theta0), 2,
                  CFG)
    _same_run(again, want)


def test_single_chain_weighted_logreg_matches_jax():
    Z, w = _logreg_data()
    key = jax.random.key(13)
    want = jhmc.hmc_sample_weighted_logreg(key, jnp.asarray(Z), jnp.asarray(w), jnp.zeros(D),
                                           CFG)
    got = thmc.hmc_sample_weighted_logreg(hmc_draws(key, 1, D, CFG, chains=False),
                                          torch.from_numpy(Z), torch.from_numpy(w),
                                          torch.zeros(D, dtype=torch.float64), CFG)
    _same_run(got, want)


@pytest.mark.parametrize("n_sub", [12, 100])
def test_full_data_logreg_matches_jax(n_sub):
    """A subsample drawn with replacement (n < N; the JAX indices given),
    or the whole data (n >= N)."""
    Z, _ = _logreg_data(N=40)
    key = jax.random.key(14)
    want = jhmc.hmc_sample_full_logreg(key, jnp.asarray(Z), jnp.zeros(D), CFG, n_subsample=n_sub)
    k_sub, k_hmc = jax.random.split(key)
    idx = (np.array(jax.random.randint(k_sub, (n_sub,), 0, 40)) if n_sub < 40 else None)
    got = thmc.hmc_sample_full_logreg(hmc_draws(k_hmc, 1, D, CFG, chains=False),
                                      torch.from_numpy(Z), torch.zeros(D, dtype=torch.float64),
                                      CFG, n_subsample=n_sub, idx=idx)
    _same_run(got, want)


def test_correlated_gaussian_moments_with_the_ports_generator():
    """The uniform-offset trajectory leaves the target invariant: 4 chains
    x 1500 draws of a correlated Gaussian (tests/test_inference.py's, with
    fewer draws) hold its mean within 0.08 and its covariance within 8 %,
    about 3.5 standard errors at this sample's ESS."""
    Sig = torch.tensor([[2.0, 0.8], [0.8, 1.0]], dtype=torch.float64)
    Siginv = torch.linalg.inv(Sig)
    cfg = thmc.HMCConfig(n_samples=1500, n_warmup=500, L_max=16)
    s, st = thmc.run_chains(torch.Generator().manual_seed(0),
                            lambda th: -0.5 * torch.sum((th @ Siginv) * th, dim=-1),
                            torch.zeros(2, dtype=torch.float64), 4, cfg)
    flat = s.reshape(-1, 2).numpy()
    assert float(st["accept_stat"].min()) > 0.6
    np.testing.assert_allclose(flat.mean(0), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), Sig.numpy(), rtol=0.08, atol=0.0)


def test_autograd_gradient_of_the_log_joint_at_zero():
    """HMC differentiates the model's log joint by autograd. At theta = 0
    every margin is 0, where softplus's derivative must be sigmoid(0) = 1/2
    (it was 1, doubling the gradient of the first leapfrog step from a zero
    init); it equals the analytic gradient and the JAX one."""
    Z, w = _logreg_data()
    Zt, wt = torch.from_numpy(Z), torch.from_numpy(w)
    lpg = thmc.make_precise_logprob_and_grad(lambda th: tlogreg.log_joint(Zt, th, wt))
    _, g = lpg(torch.zeros((1, D), dtype=torch.float64))
    want = jax.grad(lambda th: jlogreg.log_joint(jnp.asarray(Z), th, jnp.asarray(w)))(jnp.zeros(D))
    _close(g[0], want, 1e-12)
    _close(g[0], tlogreg.grad_th_log_joint(Zt, torch.zeros(D, dtype=torch.float64), wt), 1e-12)


def test_sharded_chains_name_their_roadmap_item():
    """``run_chains_sharded`` is ported (tests/test_torch_sharded_lanes.py):
    without a mesh it refuses, as the JAX one's ``require_axes`` does, for
    HMC and for a NUTS config."""
    from betacores_tpu_torch.inference import NUTSConfig

    for cfg in (thmc.HMCConfig(), NUTSConfig()):
        with pytest.raises(ValueError, match="mesh must have axes"):
            thmc.run_chains_sharded(torch.Generator(), lambda th: th.sum(-1), torch.zeros(2),
                                    2, None, cfg)
