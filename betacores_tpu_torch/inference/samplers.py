"""Posterior samplers (counterpart of betacores_tpu/inference/samplers.py).

The Laplace samplers of logistic (full or diagonal Hessian) and multiclass
(softmax) regression are ported, and ``fixed_sampler``. They keep the reference's split between drawing noise and
transforming it, so a builder can draw a whole refinement pass's noise up
front (or replay another implementation's draws):

    sampler(gen, n, wts, pts, aux) == sampler.from_noise(
        sampler.draw_noise(gen, n, wts, pts, aux), wts, pts, aux)

``aux`` is the previous Laplace mode (warm start).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import logreg, multiclass
from .laplace import (LaplaceApprox, newton_laplace, newton_laplace_diag,
                      sample_laplace_from_noise)


def _fit_dtype(wts, pts, aux) -> torch.dtype:
    """The dtype the fit computes in: the promotion of (wts, pts, aux), as
    in the reference's Newton arithmetic."""
    return torch.promote_types(torch.promote_types(wts.dtype, pts.dtype), aux.dtype)


def _laplace_noise(generator: torch.Generator, n: int, wts, pts, aux) -> torch.Tensor:
    """(n, d) standard normals in the dtype of the fitted mode: a mismatch
    would fork a pre-drawn stream from a per-step one."""
    return torch.randn((n, aux.shape[-1]), generator=generator,
                       dtype=_fit_dtype(wts, pts, aux), device=aux.device)


class _LaplaceSampler:
    """A Laplace-approximation sampler: the weighted log joint's mode by
    damped Newton (``fit``), and theta = mu + L^-T z from its factor.
    Subclasses give ``n_newton`` and ``_target(wts, pts)``, which returns
    the (log_joint, grad, hess) closures of one coreset."""

    n_newton: int

    draw_noise = staticmethod(_laplace_noise)
    from_fit = staticmethod(sample_laplace_from_noise)

    def _target(self, wts, pts):
        raise NotImplementedError

    def fit(self, wts, pts, aux, with_inverse: bool = False) -> LaplaceApprox:
        dt = _fit_dtype(wts, pts, aux)
        wts, pts, aux = wts.to(dt), pts.to(dt), aux.to(dt)
        return newton_laplace(*self._target(wts, pts), aux, n_iters=self.n_newton,
                              with_inverse=with_inverse)

    @staticmethod
    def fit_aux(lap: LaplaceApprox) -> torch.Tensor:
        return lap.mu

    def from_noise(self, z, wts, pts, aux):
        lap = self.fit(wts, pts, aux)
        return sample_laplace_from_noise(lap, z), lap.mu

    def __call__(self, generator, n, wts, pts, aux):
        return self.from_noise(self.draw_noise(generator, n, wts, pts, aux),
                               wts, pts, aux)


@dataclasses.dataclass(frozen=True)
class LogregLaplaceSampler(_LaplaceSampler):
    n_newton: int = 8

    def _target(self, wts, pts):
        return (lambda th: logreg.log_joint(pts, th, wts),
                lambda th: logreg.grad_th_log_joint(pts, th, wts),
                lambda th: logreg.hess_th_log_joint(pts, th, wts))

    def fit_inv(self, wts, pts, aux) -> LaplaceApprox:
        """Fit that also returns L^-1 (the fused refinement step consumes
        it directly: theta = mu + z @ L^-1)."""
        return self.fit(wts, pts, aux, with_inverse=True)


@dataclasses.dataclass(frozen=True)
class LogregDiagLaplaceSampler(_LaplaceSampler):
    """The diagonal-Hessian Laplace sampler (the reference's ``graddiag``):
    ``n_newton + 4`` fixed iterations of ``newton_laplace_diag``, and the
    factor diag(sqrt(-diag_hess)). It has no ``fit_inv``, as in the
    reference: the fused step forms L^-1 from the diagonal factor
    (ops/kernels.py::make_refit_state)."""

    n_newton: int = 8

    def fit(self, wts, pts, aux) -> LaplaceApprox:
        dt = _fit_dtype(wts, pts, aux)
        wts, pts, aux = wts.to(dt), pts.to(dt), aux.to(dt)
        return newton_laplace_diag(lambda th: logreg.log_joint(pts, th, wts),
                                   lambda th: logreg.grad_th_log_joint(pts, th, wts),
                                   lambda th: logreg.diag_hess_th_log_joint(pts, th, wts),
                                   aux, n_iters=self.n_newton + 4)


def logreg_laplace_sampler(diag: bool = False, n_newton: int = 8):
    """Laplace sampler for Bayesian logistic regression, with the full
    Hessian or (``diag``) its diagonal; pass zeros as the initial ``aux``."""
    if diag:
        return LogregDiagLaplaceSampler(n_newton=n_newton)
    return LogregLaplaceSampler(n_newton=n_newton)


@dataclasses.dataclass(frozen=True)
class MulticlassLaplaceSampler(_LaplaceSampler):
    """Laplace sampler for K-class softmax regression over the packed
    (K*d,) theta, with the analytic gradient and Hessian of
    models/multiclass.py. It has no ``fit_inv``, as in the reference: the
    multiclass build refines through the composed route."""

    n_classes: int
    n_newton: int = 12

    def _target(self, wts, pts):
        K = self.n_classes
        lj, g, h = (multiclass.make_log_joint(K), multiclass.make_grad_th_log_joint(K),
                    multiclass.make_hess_th_log_joint(K))
        return (lambda th: lj(pts, th, wts), lambda th: g(pts, th, wts),
                lambda th: h(pts, th, wts))


def multiclass_laplace_sampler(n_classes: int, n_newton: int = 12) -> MulticlassLaplaceSampler:
    """Laplace sampler for K-class softmax regression; pass zeros of dim
    K*d as the initial ``aux``."""
    return MulticlassLaplaceSampler(n_classes=n_classes, n_newton=n_newton)


@dataclasses.dataclass(frozen=True, eq=False)
class FixedSampler:
    """A deterministic sampler returning the first n rows of a fixed (S, d)
    ``samples`` block, whatever the coreset (reference ``fixed_sampler``:
    golden tests drive builds down identical trajectories with it). In the
    port's noise split ``draw_noise`` returns zeros of (n, d) and
    ``from_noise`` returns ``samples[:n]``, so the builders take it on
    their usual routes; it has no ``fit``, so it never serves the fused
    step or lagged refits."""

    samples: torch.Tensor

    def draw_noise(self, generator, n, wts, pts, aux):
        return torch.zeros((n, self.samples.shape[1]), dtype=self.samples.dtype,
                           device=aux.device)

    def from_noise(self, z, wts, pts, aux):
        return self.samples[:z.shape[0]], aux

    def __call__(self, generator, n, wts, pts, aux):
        return self.samples[:n], aux


def fixed_sampler(samples: torch.Tensor) -> FixedSampler:
    """A sampler that always returns ``samples[:n]``."""
    return FixedSampler(samples)
