"""Posterior samplers (counterpart of betacores_tpu/inference/samplers.py).

The Laplace samplers of logistic (full or diagonal Hessian), multiclass
(softmax) and Poisson regression, the exact conjugate samplers of the
known-covariance Gaussian and of linear regression, ``fixed_sampler`` and
``prior_gaussian_sampler`` are ported. They keep the reference's split
between drawing noise and transforming it, so a builder can draw a whole
refinement pass's noise up front (or replay another implementation's
draws):

    sampler(gen, n, wts, pts, aux) == sampler.from_noise(
        sampler.draw_noise(gen, n, wts, pts, aux), wts, pts, aux)

``aux`` is the previous Laplace mode (warm start); the conjugate samplers
pass it through. The noise is drawn in the dtype the transform computes
in: a mismatch would fork a pre-drawn stream from a per-step one. The NIW
sampler of the unknown-covariance Gaussian lives with its model
(models/mvn.py) and has no noise split.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import gaussian, linreg, logreg, multiclass, poisson
from ..models.base import Prior
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


class _DiagLaplaceSampler(_LaplaceSampler):
    """A diagonal-Hessian Laplace sampler (the reference's ``graddiag``):
    ``n_newton + 4`` fixed iterations of ``newton_laplace_diag``, and the
    factor diag(sqrt(-diag_hess)); ``_target`` returns the
    (log_joint, grad, diag_hess) closures. It has no ``fit_inv``, as in the
    reference: the fused step forms L^-1 from the diagonal factor
    (ops/kernels.py::make_refit_state)."""

    def fit(self, wts, pts, aux) -> LaplaceApprox:
        dt = _fit_dtype(wts, pts, aux)
        wts, pts, aux = wts.to(dt), pts.to(dt), aux.to(dt)
        return newton_laplace_diag(*self._target(wts, pts), aux, n_iters=self.n_newton + 4)


@dataclasses.dataclass(frozen=True)
class LogregDiagLaplaceSampler(_DiagLaplaceSampler):
    n_newton: int = 8

    def _target(self, wts, pts):
        return (lambda th: logreg.log_joint(pts, th, wts),
                lambda th: logreg.grad_th_log_joint(pts, th, wts),
                lambda th: logreg.diag_hess_th_log_joint(pts, th, wts))


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


@dataclasses.dataclass(frozen=True)
class PoissonLaplaceSampler(_LaplaceSampler):
    """Laplace sampler for Poisson regression (softplus link). Newton takes
    the expected (Fisher) Hessian, negative definite everywhere, so the fit
    is Fisher scoring. It has no ``fit_inv``, as in the reference."""

    n_newton: int = 10

    def _target(self, wts, pts):
        return (lambda th: poisson.log_joint(pts, th, wts),
                lambda th: poisson.grad_th_log_joint(pts, th, wts),
                lambda th: poisson.hess_th_log_joint(pts, th, wts))


@dataclasses.dataclass(frozen=True)
class PoissonDiagLaplaceSampler(_DiagLaplaceSampler):
    n_newton: int = 10

    def _target(self, wts, pts):
        return (lambda th: poisson.log_joint(pts, th, wts),
                lambda th: poisson.grad_th_log_joint(pts, th, wts),
                lambda th: poisson.diag_hess_th_log_joint(pts, th, wts))


def poisson_laplace_sampler(diag: bool = False, n_newton: int = 10):
    """Laplace sampler for Poisson regression, with the full expected
    Hessian or (``diag``) its diagonal; pass zeros of dim D - 1 as the
    initial ``aux``."""
    if diag:
        return PoissonDiagLaplaceSampler(n_newton=n_newton)
    return PoissonLaplaceSampler(n_newton=n_newton)


class _ConjugateSampler:
    """An exact weighted-posterior sampler of a Gaussian posterior:
    theta = mu + L^-T z from ``_post(prior, wts, pts)``. The noise is drawn
    in the dtype the posterior computes in, the promotion of the prior's,
    the weights' and the rows' (as the reference's ``draw_noise`` reads it
    off the posterior). It has no ``fit``: lagged refits raise."""

    def __init__(self, *prior):
        self.prior = Prior(*prior)

    def _post(self, prior, wts, pts) -> gaussian.GaussianPosterior:
        raise NotImplementedError

    def _dtype(self, wts, pts) -> torch.dtype:
        return torch.promote_types(self.prior.dtype,
                                   torch.promote_types(wts.dtype, pts.dtype))

    def posterior(self, wts, pts) -> gaussian.GaussianPosterior:
        dt = self._dtype(wts, pts)
        return self._post(self.prior.at(dt, pts.device), wts.to(dt), pts.to(dt))

    def draw_noise(self, generator, n, wts, pts, aux):
        return torch.randn((n, self.prior.tensors[0].shape[0]), generator=generator,
                           dtype=self._dtype(wts, pts), device=pts.device)

    def from_noise(self, z, wts, pts, aux):
        return gaussian.sample_gaussian_prec_from_noise(self.posterior(wts, pts), z), aux

    def __call__(self, generator, n, wts, pts, aux):
        return self.from_noise(self.draw_noise(generator, n, wts, pts, aux), wts, pts, aux)


class GaussianConjugateSampler(_ConjugateSampler):
    """The known-covariance Gaussian's exact weighted posterior."""

    def _post(self, prior, wts, pts):
        mu0, Sig0inv, Siginv = prior
        return gaussian.weighted_post(mu0, Sig0inv, Siginv, pts, wts)


def gaussian_conjugate_sampler(mu0, Sig0inv, Siginv) -> GaussianConjugateSampler:
    """Exact weighted-posterior sampler of the known-covariance Gaussian
    (with the correct factor order, models/gaussian.py)."""
    return GaussianConjugateSampler(mu0, Sig0inv, Siginv)


class LinregConjugateSampler(_ConjugateSampler):
    """Bayesian linear regression's exact weighted posterior."""

    def __init__(self, mu0, Sig0inv, sigsq):
        super().__init__(mu0, Sig0inv)
        self.sigsq = sigsq

    def _post(self, prior, wts, pts):
        mu0, Sig0inv = prior
        return linreg.weighted_post(mu0, Sig0inv, self.sigsq, pts, wts)


def linreg_conjugate_sampler(mu0, Sig0inv, sigsq) -> LinregConjugateSampler:
    """Exact weighted-posterior sampler of Bayesian linear regression with
    noise variance ``sigsq``."""
    return LinregConjugateSampler(mu0, Sig0inv, sigsq)


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


class PriorGaussianSampler:
    """Draws from a fixed Gaussian N(mu, LSig LSig^T) whatever the coreset
    (the reference's mis-tuned "realistic" projector). The reference draws
    in one call; the port splits it like the other samplers
    (``draw_noise``: z ~ N(0, I) in mu's dtype, ``from_noise``:
    mu + z @ LSig^T), so the builders take it on their usual routes."""

    def __init__(self, mu, LSig):
        self.prior = Prior(mu, LSig)

    def draw_noise(self, generator, n, wts, pts, aux):
        mu = self.prior.tensors[0]
        return torch.randn((n, mu.shape[0]), generator=generator, dtype=mu.dtype,
                           device=pts.device)

    def from_noise(self, z, wts, pts, aux):
        mu, LSig = self.prior.at(self.prior.dtype, z.device)
        return mu + z @ LSig.T, aux

    def __call__(self, generator, n, wts, pts, aux):
        return self.from_noise(self.draw_noise(generator, n, wts, pts, aux), wts, pts, aux)


def prior_gaussian_sampler(mu, LSig) -> PriorGaussianSampler:
    """A sampler of the fixed Gaussian N(mu, LSig LSig^T)."""
    return PriorGaussianSampler(mu, LSig)
