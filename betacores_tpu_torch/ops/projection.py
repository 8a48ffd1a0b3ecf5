"""Projection engine (counterpart of betacores_tpu/ops/projection.py).

The projection of a point z under S posterior samples is the S-vector of
centered (beta-)log-likelihoods v_n = ll(z_n, th_s) - mean_s ll(z_n, th_s).
"""

from __future__ import annotations

from typing import Tuple

import torch


def center(v: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return v - v.mean(dim=dim, keepdim=True)


def project_ll(model, pts, samples):
    """Centered (N, S) log-likelihood projection."""
    return center(model.log_likelihood(pts, samples))


def project_beta(model, pts, samples, beta):
    """Centered (N, S) beta-likelihood projection."""
    return center(model.beta_likelihood(pts, samples, beta))


def draw_subsample(generator: torch.Generator, n_total: int,
                   n_subsample: int) -> Tuple[torch.Tensor, float]:
    """Uniform with-replacement subsample indices on the generator's device,
    and the importance rescale sum_scaling = N / n."""
    idcs = torch.randint(0, n_total, (n_subsample,), generator=generator,
                         device=generator.device)
    return idcs, n_total / n_subsample
