"""Projection engine (counterpart of betacores_tpu/ops/projection.py).

The projection of a point z under S posterior samples is the S-vector of
centered (beta-)log-likelihoods v_n = ll(z_n, th_s) - mean_s ll(z_n, th_s).
"""

from __future__ import annotations

from typing import Tuple

import torch


def center(v: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return v - v.mean(dim=dim, keepdim=True)


def _use_fused(model, field: str, n_rows: int) -> bool:
    from .kernels import maybe_fused

    return getattr(model, field, None) is not None and maybe_fused(n_rows)


def project_ll(model, pts, samples):
    """Centered (N, S) log-likelihood projection. Row blocks of at least
    FUSED_MIN_ROWS go to the model's fused projection when it has one."""
    if _use_fused(model, "fused_ll_projection", pts.shape[0]):
        return model.fused_ll_projection(pts, samples)
    return center(model.log_likelihood(pts, samples))


def project_beta(model, pts, samples, beta):
    """Centered (N, S) beta-likelihood projection, routed as ``project_ll``."""
    if _use_fused(model, "fused_beta_projection", pts.shape[0]):
        return model.fused_beta_projection(pts, samples, beta)
    return center(model.beta_likelihood(pts, samples, beta))


def project_ll_with_grad(model, pts, samples):
    """Centred log-likelihood and data-gradient projections, ((N, S),
    (N, S, D)), both centred over the sample axis."""
    lls = center(model.log_likelihood(pts, samples))
    glls = model.grad_z_log_likelihood(pts, samples)
    return lls, glls - glls.mean(dim=1, keepdim=True)


def project_beta_with_grad(model, pts, samples, beta):
    """Centred beta-likelihood projection and its centred d/d(beta), for
    the joint (w, beta) refinement. Always the plain ``beta_likelihood``:
    the fused projections have no beta-gradient."""
    return (center(model.beta_likelihood(pts, samples, beta)),
            center(model.beta_gradient(pts, samples, beta)))


def draw_subsample(generator: torch.Generator, n_total: int,
                   n_subsample: int) -> Tuple[torch.Tensor, float]:
    """Uniform with-replacement subsample indices on the generator's device,
    and the importance rescale sum_scaling = N / n."""
    idcs = torch.randint(0, n_total, (n_subsample,), generator=generator,
                         device=generator.device)
    return idcs, n_total / n_subsample
