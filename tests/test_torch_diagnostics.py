"""The port's MCMC diagnostics and escalation policy
(betacores_tpu_torch/inference/diagnostics.py, escalation.py) against the
JAX package's, on the same float64 chains (made with numpy), to rtol 1e-10:
both take the same FFT and sums, which differ in the last bits only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference import diagnostics as jdiag
from betacores_tpu.inference import escalation as jesc
from betacores_tpu_torch.inference import diagnostics as tdiag
from betacores_tpu_torch.inference import escalation as tesc

RTOL = 1e-10


def _stack(kind: str, n: int = 201):
    """(C, n, d) float64 chains: iid normals, AR(1) (phi 0.9), or some
    chains stuck (zero within-chain variance) at different values."""
    rng = np.random.default_rng({"random": 0, "ar1": 1, "stuck": 2}[kind])
    C, d = 4, 3
    x = rng.normal(size=(C, n, d))
    if kind == "ar1":
        for t in range(1, n):
            x[:, t] = 0.9 * x[:, t - 1] + np.sqrt(1 - 0.81) * x[:, t]
    if kind == "stuck":
        x[:, :, 1] = np.arange(C)[:, None]            # stuck apart: +inf
        x[:, :, 2] = 5.0                              # stuck together: 1
    return x


@pytest.mark.parametrize("kind", ["random", "ar1", "stuck"])
@pytest.mark.parametrize("n", [201, 64])
def test_diagnostics_match_jax(kind, n):
    x = _stack(kind, n)
    got = {k: v.numpy() for k, v in tdiag.summarize_chains(torch.from_numpy(x)).items()}
    want = {k: np.asarray(v) for k, v in jdiag.summarize_chains(jnp.asarray(x)).items()}
    for k in ("rhat", "ess", "mean", "sd"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tdiag.split_rhat(torch.from_numpy(x)).numpy(), want["rhat"],
                               rtol=RTOL)
    np.testing.assert_allclose(tdiag.effective_sample_size(torch.from_numpy(x)).numpy(),
                               want["ess"], rtol=RTOL)
    if kind == "stuck":
        assert np.isinf(got["rhat"][1]) and got["rhat"][2] == 1.0


def test_single_chain_ess_matches_jax():
    x = _stack("ar1")[:1]
    np.testing.assert_allclose(tdiag.effective_sample_size(torch.from_numpy(x)).numpy(),
                               np.asarray(jdiag.effective_sample_size(jnp.asarray(x))),
                               rtol=RTOL)


def _summary(x):
    return (tdiag.summarize_chains(torch.from_numpy(x)),
            jdiag.summarize_chains(jnp.asarray(x)))


@pytest.mark.parametrize("case", ["clean", "rhat", "ess", "divergent", "nan"])
def test_diagnostics_failed_strings_equal(case):
    x = _stack("random", 400)
    stats = None
    if case == "rhat":
        x = x + np.linspace(-3, 3, 4)[:, None, None]
    elif case == "ess":
        x = _stack("ar1", 201)
        x = x.cumsum(axis=1) * 0.01 + x * 0.0
    elif case == "divergent":
        stats = {"n_divergent": np.asarray([0, 2, 1, 0])}
    elif case == "nan":
        x[0, 3, 0] = np.nan
    got_s, want_s = _summary(x)
    t_stats = None if stats is None else {"n_divergent": torch.from_numpy(stats["n_divergent"])}
    got = tesc.diagnostics_failed(got_s, t_stats)
    assert got == jesc.diagnostics_failed(want_s, stats)
    assert (got == "") == (case == "clean")


def _mixed(gen):
    return torch.randn((8, 150, 2), generator=gen, dtype=torch.float64)


def _stuck(gen):
    offs = torch.linspace(-3.0, 3.0, 8, dtype=torch.float64)[:, None, None]
    return 0.1 * torch.randn((8, 150, 2), generator=gen, dtype=torch.float64) + offs


def test_escalates_and_records_provenance():
    calls = []

    def bad_primary(key, Z, w, cfg):
        calls.append(("hmc", key.initial_seed(), key.get_state().clone()))
        return _stuck(key), {"accept_stat": torch.ones(8)}

    def nuts(key, Z, w, cfg):
        calls.append(("nuts", key.initial_seed(), key.get_state().clone()))
        return _mixed(key), {"accept_stat": torch.ones(8), "n_divergent": torch.zeros(8)}

    run = tesc.run_with_escalation(torch.Generator().manual_seed(0), bad_primary, None, nuts,
                                   None, torch.zeros((3, 2)), torch.ones(3))
    assert [c[0] for c in calls] == ["hmc", "nuts"]
    # the same key: the generator is set back before the NUTS run
    assert torch.equal(calls[0][2], calls[1][2])
    assert run.escalated and run.sampler_used == "nuts"
    assert "split-R-hat" in run.failure_reason
    assert float(run.summary["rhat"].max()) < 1.05


def test_clean_primary_not_escalated():
    def good_primary(key, Z, w, cfg):
        return _mixed(key), {"accept_stat": torch.ones(8)}

    def nuts(key, Z, w, cfg):  # pragma: no cover - must not run
        raise AssertionError("escalated a clean run")

    run = tesc.run_with_escalation(torch.Generator().manual_seed(0), good_primary, None, nuts,
                                   None, torch.zeros((3, 2)), torch.ones(3))
    assert not run.escalated and run.sampler_used == "hmc" and run.failure_reason == ""


def test_nuts_primary_never_reescalates():
    def stuck_nuts(key, Z, w, cfg):
        return _stuck(key), {"accept_stat": torch.ones(8)}

    run = tesc.run_with_escalation(torch.Generator().manual_seed(0), stuck_nuts, None,
                                   stuck_nuts, None, torch.zeros((3, 2)), torch.ones(3),
                                   primary_name="nuts")
    assert not run.escalated and run.sampler_used == "nuts"
    assert "split-R-hat" in run.failure_reason


def test_thresholds_and_nuts_config_match_jax():
    assert (tesc.DEFAULT_RHAT_MAX, tesc.DEFAULT_ESS_MIN) == (jesc.DEFAULT_RHAT_MAX,
                                                             jesc.DEFAULT_ESS_MIN)
    assert tuple(tesc.default_nuts_config(700, 300)) == tuple(jesc.default_nuts_config(700, 300))
    assert tesc.EvalRun._fields == jesc.EvalRun._fields
