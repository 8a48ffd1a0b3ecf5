"""MCMC convergence diagnostics: split-R-hat and effective sample size
(counterpart of betacores_tpu/inference/diagnostics.py).

The classic split-R-hat and the Geyer-truncated ESS that Stan reports as
``n_eff``, O(C n log n) through an FFT autocovariance, on the device of the
draws. ``samples`` is (C, n, d): chains x draws x parameters (the stack
``run_chains`` returns); every diagnostic is per parameter, (d,).
"""

from __future__ import annotations

import torch


def _split_chains(samples: torch.Tensor) -> torch.Tensor:
    """(C, n, d) -> (2C, n//2, d): each chain cut in half, so that split-R-hat
    sees within-chain non-stationarity."""
    C, n, d = samples.shape
    half = n // 2
    return samples[:, : 2 * half].reshape(C * 2, half, d)


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split potential-scale-reduction factor per parameter (d,): about 1 at
    convergence. Stuck chains (no within-chain variance) at different values
    give +inf, never 0. Needs n >= 4."""
    s = _split_chains(torch.as_tensor(samples))
    n = s.shape[1]
    chain_mean = s.mean(dim=1)                           # (m, d)
    chain_var = s.var(dim=1, correction=1)               # (m, d)
    W = chain_var.mean(dim=0)                            # within
    B = n * chain_mean.var(dim=0, correction=1)          # between
    var_plus = (n - 1) / n * W + B / n
    rhat = torch.sqrt(var_plus / torch.where(W > 0, W, torch.ones_like(W)))
    inf, one = torch.full_like(W, float("inf")), torch.ones_like(W)
    return torch.where(W > 0, rhat, torch.where(B > 0, inf, one))


def _autocovariance(x: torch.Tensor) -> torch.Tensor:
    """Biased (1/n) autocovariance of each column of (..., n, d) chains, by
    an FFT at the next power of two >= 2n (linear, not circular)."""
    n = x.shape[-2]
    xc = x - x.mean(dim=-2, keepdim=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(xc, n=nfft, dim=-2)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=-2)[..., :n, :]
    return acov / n


def effective_sample_size(samples: torch.Tensor) -> torch.Tensor:
    """Per-parameter ESS over all chains (d,), Stan's n_eff: the combined
    autocorrelation from the within- and between-chain variances, truncated
    by Geyer's initial monotone positive-pair-sum sequence."""
    s = _split_chains(torch.as_tensor(samples))
    m, n, d = s.shape
    acov = _autocovariance(s)                            # (m, n, d)
    chain_mean = s.mean(dim=1)
    chain_var = acov[:, 0] * n / (n - 1.0)               # (m, d) unbiased
    W = chain_var.mean(dim=0)
    B_over_n = (chain_mean.var(dim=0, correction=1) if m > 1
                else torch.zeros(d, dtype=s.dtype, device=s.device))
    var_plus = (n - 1.0) / n * W + B_over_n
    denom = torch.where(var_plus > 0, var_plus, torch.full_like(var_plus, float("inf")))
    rho = 1.0 - (W - acov.mean(dim=0)) / denom
    rho[0] = 1.0                                         # (n, d)
    # Geyer pair sums P_k = rho_2k + rho_2k+1, kept while positive, then
    # made monotone non-increasing
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)
    positive = torch.cumprod((pairs > 0).to(s.dtype), dim=0)
    pairs = torch.cummin(pairs * positive, dim=0).values
    pairs = torch.clamp_min(pairs, 0.0)
    tau = -1.0 + 2.0 * pairs.sum(dim=0)
    return m * n / torch.clamp_min(tau, 1.0 / (m * n))


def summarize_chains(samples: torch.Tensor) -> dict:
    """{'rhat', 'ess', 'mean', 'sd'}, each (d,), of a (C, n, d) stack."""
    samples = torch.as_tensor(samples)
    flat = samples.reshape(-1, samples.shape[-1])
    return {"rhat": split_rhat(samples), "ess": effective_sample_size(samples),
            "mean": flat.mean(dim=0), "sd": flat.std(dim=0, correction=1)}
