"""Posterior samplers (counterpart of betacores_tpu/inference/samplers.py).

Only the logistic-regression Laplace sampler is ported. It keeps the
reference's split between drawing noise and transforming it, so a builder
can draw a whole refinement pass's noise up front (or replay another
implementation's draws):

    sampler(gen, n, wts, pts, aux) == sampler.from_noise(
        sampler.draw_noise(gen, n, wts, pts, aux), wts, pts, aux)

``aux`` is the previous Laplace mode (warm start).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import logreg
from .laplace import LaplaceApprox, newton_laplace, sample_laplace_from_noise


def _fit_dtype(wts, pts, aux) -> torch.dtype:
    """The dtype the fit computes in: the promotion of (wts, pts, aux), as
    in the reference's Newton arithmetic."""
    return torch.promote_types(torch.promote_types(wts.dtype, pts.dtype), aux.dtype)


def _laplace_noise(generator: torch.Generator, n: int, wts, pts, aux) -> torch.Tensor:
    """(n, d) standard normals in the dtype of the fitted mode: a mismatch
    would fork a pre-drawn stream from a per-step one."""
    return torch.randn((n, aux.shape[-1]), generator=generator,
                       dtype=_fit_dtype(wts, pts, aux), device=aux.device)


@dataclasses.dataclass(frozen=True)
class LogregLaplaceSampler:
    n_newton: int = 8

    draw_noise = staticmethod(_laplace_noise)
    from_fit = staticmethod(sample_laplace_from_noise)

    def fit(self, wts, pts, aux, with_inverse: bool = False) -> LaplaceApprox:
        dt = _fit_dtype(wts, pts, aux)
        wts, pts, aux = wts.to(dt), pts.to(dt), aux.to(dt)
        return newton_laplace(
            lambda th: logreg.log_joint(pts, th, wts),
            lambda th: logreg.grad_th_log_joint(pts, th, wts),
            lambda th: logreg.hess_th_log_joint(pts, th, wts),
            aux, n_iters=self.n_newton, with_inverse=with_inverse)

    def fit_inv(self, wts, pts, aux) -> LaplaceApprox:
        """Fit that also returns L^-1 (the fused refinement step consumes
        it directly: theta = mu + z @ L^-1)."""
        return self.fit(wts, pts, aux, with_inverse=True)

    @staticmethod
    def fit_aux(lap: LaplaceApprox) -> torch.Tensor:
        return lap.mu

    def from_noise(self, z, wts, pts, aux):
        lap = self.fit(wts, pts, aux)
        return sample_laplace_from_noise(lap, z), lap.mu

    def __call__(self, generator, n, wts, pts, aux):
        return self.from_noise(self.draw_noise(generator, n, wts, pts, aux),
                               wts, pts, aux)


def logreg_laplace_sampler(n_newton: int = 8) -> LogregLaplaceSampler:
    """Laplace sampler for Bayesian logistic regression; pass zeros as the
    initial ``aux``."""
    return LogregLaplaceSampler(n_newton=n_newton)
