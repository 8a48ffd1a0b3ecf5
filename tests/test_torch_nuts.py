"""The port's NUTS (betacores_tpu_torch/inference/nuts.py) against the JAX
package's (betacores_tpu/inference/nuts.py) under the JAX draws, rebuilt
from its keys (tests/torch_jax_mcmc.py), in float64: single transitions at
max_treedepth = 6 to rtol 1e-10 (proposal, accept statistic) and exactly
(depth, leapfrog steps, divergence); a whole adaptive run (d = 3, 40 + 40
iterations) to rtol 1e-8, as tests/test_torch_hmc.py holds HMC's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference import hmc as jhmc
from betacores_tpu.inference import nuts as jnuts
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu_torch.inference import hmc as thmc
from betacores_tpu_torch.inference import nuts as tnuts
from betacores_tpu_torch.models import logreg as tlogreg
from tests.torch_jax_mcmc import nuts_draws, nuts_iteration_draws

T = 6
SD = np.logspace(-1, 0.5, 4)


def _gauss():
    sd_t = torch.from_numpy(SD)
    return (lambda th: -0.5 * torch.sum((th / sd_t) ** 2, dim=-1),
            lambda th: -0.5 * jnp.sum((th / jnp.asarray(SD)) ** 2))


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol,
                               err_msg=what)


def test_popcount_and_trailing_zeros_match_jax():
    x = np.arange(0, 4097, dtype=np.int32)
    pc = np.asarray(jnuts._popcount(jnp.asarray(x)))
    tz = np.asarray(jnuts._trailing_zeros(jnp.asarray(x)))
    np.testing.assert_array_equal(tnuts._popcount(torch.from_numpy(x)).numpy(), pc)
    np.testing.assert_array_equal(tnuts._trailing_zeros(torch.from_numpy(x)).numpy(), tz)
    assert [tnuts._popcount(int(v)) for v in x] == pc.tolist()
    assert [tnuts._trailing_zeros(int(v)) for v in x] == tz.tolist()


def _transitions(keys, theta, eps, inv_mass, tlp, jlp):
    """The port's batched transition and the JAX one of each chain."""
    draws = tuple(torch.from_numpy(np.array(x)) for x in nuts_iteration_draws(keys, len(SD), T))
    got = tnuts._nuts_transition(draws, thmc.make_precise_logprob_and_grad(tlp),
                                 torch.from_numpy(theta), torch.from_numpy(eps), torch.from_numpy(
                                     inv_mass), T, 1000.0)
    jlpg = jhmc.make_precise_logprob_and_grad(jlp)
    want = [jnuts._nuts_transition(keys[c], jlpg, jnp.asarray(theta[c]), jnp.asarray(eps[c]),
                                   jnp.asarray(inv_mass[c]), T, 1000.0)
            for c in range(len(eps))]
    return draws, got, want


def test_nuts_transition_matches_jax():
    """Five chains: step sizes from the U-turning to the divergent, one so
    large that the first doubling is rejected (depth 0, tests/
    test_inference.py's case)."""
    tlp, jlp = _gauss()
    rng = np.random.default_rng(0)
    eps = np.asarray([0.02, 0.1, 0.3, 0.9, 1e6])
    theta = rng.normal(size=(5, len(SD))) * SD
    inv_mass = rng.uniform(0.5, 1.5, size=(5, len(SD)))
    _, got, want = _transitions(jax.random.split(jax.random.key(1), 5), theta, eps, inv_mass,
                                tlp, jlp)
    th, acc, (depth, n_leap, div) = got
    for c, (th_j, acc_j, (depth_j, n_leap_j, div_j)) in enumerate(want):
        _close(th[c], th_j, 1e-10, f"proposal, chain {c}")
        _close(acc[c], acc_j, 1e-10, f"accept, chain {c}")
        assert (int(depth[c]), float(n_leap[c]), int(div[c])) == (
            int(depth_j), float(n_leap_j), int(div_j)), c
    assert len(set(depth.tolist())) >= 3            # several depths were reached
    assert int(depth[4]) == 0 and int(div[4]) == 1  # the rejected first doubling
    assert torch.equal(th[4], torch.from_numpy(theta[4]))


def test_batched_chains_equal_their_runs_alone():
    """Two chains in one batch, one of which stops doublings earlier than
    the other: each equals its own transition alone (frozen under masks, as
    the vmapped while_loop keeps it)."""
    tlp, _ = _gauss()
    lpg = thmc.make_precise_logprob_and_grad(tlp)
    keys = jax.random.split(jax.random.key(2), 2)
    draws = tuple(torch.from_numpy(np.array(x)) for x in nuts_iteration_draws(keys, len(SD), T))
    rng = np.random.default_rng(1)
    theta = torch.from_numpy(rng.normal(size=(2, len(SD))) * SD)
    eps = torch.tensor([0.9, 0.02], dtype=torch.float64)
    inv_mass = torch.ones((2, len(SD)), dtype=torch.float64)
    th, acc, extras = tnuts._nuts_transition(draws, lpg, theta, eps, inv_mass, T, 1000.0)
    assert int(extras[0][0]) < int(extras[0][1])
    for c in range(2):
        one = tuple(x[c:c + 1] for x in draws)
        th1, acc1, ex1 = tnuts._nuts_transition(one, lpg, theta[c:c + 1], eps[c:c + 1],
                                                inv_mass[c:c + 1], T, 1000.0)
        _close(th[c], th1[0], 1e-14)
        _close(acc[c], acc1[0], 1e-14)
        assert [int(x[c]) for x in extras] == [int(x[0]) for x in ex1]


def _logreg_targets():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(30, 3))
    y = np.where(rng.uniform(size=30) < 1 / (1 + np.exp(-X.sum(1))), 1.0, -1.0)
    Z, w = y[:, None] * X, rng.uniform(0.5, 2.0, size=30)
    return Z, w


def test_run_chains_nuts_matches_jax():
    Z, w = _logreg_targets()
    Zt, wt = torch.from_numpy(Z), torch.from_numpy(w)
    cfg = jnuts.NUTSConfig(n_samples=40, n_warmup=40, max_treedepth=T)
    key = jax.random.key(6)
    want_s, want = jnuts.run_chains_nuts(
        key, lambda th: jlogreg.log_joint(jnp.asarray(Z), th, jnp.asarray(w)), jnp.zeros(3), 2,
        cfg)
    got_s, got = tnuts.run_chains_nuts(nuts_draws(key, 2, 3, cfg),
                                       lambda th: tlogreg.log_joint(Zt, th, wt),
                                       torch.zeros(3, dtype=torch.float64), 2, cfg)
    _close(got_s, want_s, 1e-8, "samples")
    for k in ("step_size", "accept_stat", "inv_mass", "warmup_accept", "mean_treedepth",
              "max_treedepth", "mean_leapfrog", "n_divergent"):
        _close(got[k], want[k], 1e-8, k)


def test_nuts_sample_and_weighted_chains_match_jax():
    """The one-chain entry point, and the weighted-logreg chains (the
    escalation target's runner)."""
    Z, w = _logreg_targets()
    cfg = jnuts.NUTSConfig(n_samples=20, n_warmup=20, max_treedepth=T)
    key = jax.random.key(7)
    want_s, want = jnuts.nuts_sample(
        key, lambda th: jlogreg.log_joint(jnp.asarray(Z), th, jnp.asarray(w)), jnp.zeros(3), cfg)
    Zt, wt = torch.from_numpy(Z), torch.from_numpy(w)
    got_s, got = tnuts.nuts_sample(nuts_draws(key, 1, 3, cfg, chains=False),
                                   lambda th: tlogreg.log_joint(Zt, th, wt),
                                   torch.zeros(3, dtype=torch.float64), cfg)
    _close(got_s, want_s, 1e-8, "samples")
    _close(got["mean_leapfrog"], want["mean_leapfrog"], 1e-12)
    want_c, want_st = jnuts.run_chains_weighted_logreg_nuts(key, jnp.asarray(Z), jnp.asarray(w),
                                                            jnp.zeros(3), 2, cfg)
    got_c, got_st = tnuts.run_chains_weighted_logreg_nuts(nuts_draws(key, 2, 3, cfg), Zt, wt,
                                                          torch.zeros(3, dtype=torch.float64),
                                                          2, cfg)
    _close(got_c, want_c, 1e-8, "weighted chains")
    _close(got_st["n_divergent"], want_st["n_divergent"], 0)


def test_generator_draws_shapes():
    cfg = tnuts.NUTSConfig(n_samples=3, n_warmup=4, max_treedepth=4)
    d = tnuts.draw_nuts(torch.Generator().manual_seed(0), 2, 3, cfg, torch.float64)
    assert d.init.shape == (2, 3)
    for ph, n in zip(d.phases, thmc.phase_lengths(cfg)):
        assert ph.z.shape == (n, 2, 3) and ph.right.dtype == torch.bool
        assert ph.swap.shape == (n, 2, 4) and ph.leaf.shape == (n, 2, 15)


@pytest.mark.parametrize("n_chains", [1, 3])
def test_generator_run_counts_doublings_and_reads(n_chains):
    """On the port's own generator: at most one host read per doubling
    (none after the last), every draw through the begin and end graphs."""
    tlp, _ = _gauss()
    cfg = tnuts.NUTSConfig(n_samples=10, n_warmup=10, max_treedepth=5)
    run = thmc._Adaptive(tnuts._NUTSKernel(thmc.make_precise_logprob_and_grad(tlp), n_chains,
                                           len(SD), cfg, torch.float64, torch.device("cpu")),
                         n_chains, len(SD), cfg, torch.float64, torch.device("cpu"), False)
    draws = tnuts.draw_nuts(torch.Generator().manual_seed(3), n_chains, len(SD), cfg,
                            torch.float64)
    s, st = run.run(torch.zeros((n_chains, len(SD)), dtype=torch.float64), draws.phases)
    c = run.kernel.counts
    assert c["draws"] == 20 and c["draws"] <= c["doublings"] <= 5 * c["draws"]
    assert c["host_reads"] <= c["doublings"]
    assert bool(torch.isfinite(s).all()) and float(st["mean_treedepth"].min()) >= 1.0
