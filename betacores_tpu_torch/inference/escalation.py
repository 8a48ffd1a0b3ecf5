"""Diagnostic-gated sampler escalation for the evaluation loops
(counterpart of betacores_tpu/inference/escalation.py).

The primary sampler (fixed-budget HMC) runs first; when split-R-hat, the
smallest ESS or a divergence says it failed, that evaluation runs again with
dynamic-trajectory NUTS, and the record says which sampler produced the
numbers. As in the reference, the escalated NUTS run's own diagnostics are
recorded but not checked again.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .diagnostics import summarize_chains

# Stan's practical thresholds: R-hat above 1.05, bulk ESS under 100, or any
# divergence means the run failed
DEFAULT_RHAT_MAX = 1.05
DEFAULT_ESS_MIN = 100.0


class EvalRun(NamedTuple):
    """One evaluated coreset size's MCMC output and its provenance."""

    chains: torch.Tensor         # (C, n, d) draws of the recorded sampler
    stats: dict                  # per-chain sampler stats (accept_stat, ...)
    summary: dict                # summarize_chains() of the recorded draws
    sampler_used: str            # "hmc" | "nuts"
    escalated: bool              # True when NUTS re-ran a failed primary
    failure_reason: str          # why the primary failed ("" if it passed)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def diagnostics_failed(summary: dict, stats: Optional[dict] = None, *,
                       rhat_max: float = DEFAULT_RHAT_MAX,
                       ess_min: float = DEFAULT_ESS_MIN) -> str:
    """A human-readable failure reason, or "" when the run is clean: first
    divergences (where the sampler reports them), then split-R-hat, then the
    smallest ESS."""
    if stats is not None and "n_divergent" in stats:
        n_div = int(_host(stats["n_divergent"]).sum())
        if n_div > 0:
            return f"{n_div} divergent transitions"
    rhat = float(_host(summary["rhat"]).max())
    if not rhat < rhat_max:  # catches NaN too
        return f"split-R-hat {rhat:.3f} > {rhat_max}"
    ess = float(_host(summary["ess"]).min())
    if not ess >= ess_min:
        return f"min ESS {ess:.0f} < {ess_min:.0f}"
    return ""


def run_with_escalation(key, run_primary: Callable, primary_cfg,
                        run_nuts: Optional[Callable], nuts_cfg, *runner_args,
                        primary_name: str = "hmc", rhat_max: float = DEFAULT_RHAT_MAX,
                        ess_min: float = DEFAULT_ESS_MIN) -> EvalRun:
    """``run_primary(key, *runner_args, primary_cfg)``; on failed
    diagnostics ``run_nuts(key, *runner_args, nuts_cfg)`` with the same key
    (a sampler change, not a reseed: a ``torch.Generator`` is set back to
    its state before the primary) and the NUTS numbers recorded. A NUTS
    primary (``run_nuts`` None or ``primary_name == 'nuts'``) is checked
    and recorded, never re-run."""
    state = key.get_state() if isinstance(key, torch.Generator) else None
    chains, stats = run_primary(key, *runner_args, primary_cfg)
    summary = summarize_chains(chains)
    reason = diagnostics_failed(summary, stats, rhat_max=rhat_max, ess_min=ess_min)
    if not reason or run_nuts is None or primary_name == "nuts":
        return EvalRun(chains, stats, summary, primary_name, False, reason)
    if state is not None:
        key.set_state(state)
    chains, stats = run_nuts(key, *runner_args, nuts_cfg)
    return EvalRun(chains, stats, summarize_chains(chains), "nuts", True, reason)


def default_nuts_config(mcmc_samples: int, mcmc_warmup: int):
    """The escalation target, matched to the reference's PyStan call
    (adapt_delta 0.9 -> target_accept 0.9; max_treedepth 10, Stan's own
    default)."""
    from .nuts import NUTSConfig

    return NUTSConfig(n_samples=mcmc_samples, n_warmup=mcmc_warmup,
                      max_treedepth=10, target_accept=0.9)
