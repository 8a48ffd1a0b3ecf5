"""Multivariate Gaussian with known covariance, unknown mean (counterpart of
betacores_tpu/models/gaussian.py).

Data x ~ N(theta, Sig) with Sig known; prior theta ~ N(mu0, Sig0). The
weighted posterior is conjugate and exact, so this family is the closed-form
ground truth of end-to-end KL checks.

Every (N, S) function is built on one pairwise squared-Mahalanobis matrix
d2[n, s] = (x_n - th_s)^T Siginv (x_n - th_s), whose N x S cross term is one
matmul.

As in the reference, ``weighted_post`` composes the triangular factors in
the correct order: with L = chol(SigpInv), Sigp = L^-T L^-1 (the original
reference's L^-1 L^-T is a bug the JAX package documents and does not
reproduce), and ``sample_gaussian_prec`` draws theta = mu + L^-T z.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .base import ModelFns, as_beta, identity

_LOG2PI = math.log(2.0 * math.pi)


def pairwise_mahalanobis_sq(x, th, Siginv):
    """d2[n, s] = (x_n - th_s)^T Siginv (x_n - th_s), shape (N, S)."""
    xS = x @ Siginv
    thS = th @ Siginv
    x_quad = torch.sum(xS * x, dim=-1)
    th_quad = torch.sum(thS * th, dim=-1)
    return x_quad[:, None] + th_quad[None, :] - 2.0 * (xS @ th.T)


def log_likelihood(x, th, Siginv, logdetSig):
    """(N, S) Gaussian log-density log N(x_n | th_s, Sig)."""
    d = x.shape[-1]
    return -0.5 * d * _LOG2PI - 0.5 * logdetSig - 0.5 * pairwise_mahalanobis_sq(x, th, Siginv)


def grad_x_log_likelihood(x, th, Siginv):
    """(N, S, d) gradient w.r.t. the data point x_n: Siginv (th_s - x_n)."""
    return (th @ Siginv)[None, :, :] - (x @ Siginv)[:, None, :]


def beta_likelihood(x, th, beta, Siginv, logdetSig):
    """(N, S) beta-divergence surrogate (1/beta) exp(-beta/2 d2)
    - (1+beta)^(-d/2-1), in the reference's form, which drops the
    normaliser's constant factor (``logdetSig`` is unused)."""
    del logdetSig
    d = x.shape[-1]
    d2 = pairwise_mahalanobis_sq(x, th, Siginv)
    return (1.0 / beta) * torch.exp(-0.5 * beta * d2) - (1.0 + beta) ** (-0.5 * d - 1.0)


def beta_gradient(x, th, beta, Siginv, logdetSig):
    """(N, S) d/d(beta) of ``beta_likelihood`` (the dropped-constant form)
    in closed form: -(1/beta^2 + d2/(2 beta)) exp(-beta/2 d2)
    + (d/2 + 1) (1+beta)^(-d/2-2)."""
    del logdetSig
    beta = as_beta(beta, x)
    d = x.shape[-1]
    d2 = pairwise_mahalanobis_sq(x, th, Siginv)
    return (-(1.0 / (beta * beta) + 0.5 * d2 / beta) * torch.exp(-0.5 * beta * d2)
            + (0.5 * d + 1.0) * (1.0 + beta) ** (-0.5 * d - 2.0))


def beta_gradient_reference(x, th, beta, Siginv, logdetSig):
    """The reference's hand-derived d/d(beta), kept for parity checks. It
    includes normaliser terms its own ``beta_likelihood`` drops, so it is
    not that function's derivative; ``bundle`` takes ``beta_gradient``."""
    d = float(x.shape[-1])
    d2 = pairwise_mahalanobis_sq(x, th, Siginv)
    logcnst = -0.5 * d * _LOG2PI - 0.5 * logdetSig
    gaussq = torch.exp(-0.5 * beta * d2)
    t12 = (1.0 + beta) ** (-0.5 * d - 1.0)
    t1 = logcnst * (gaussq / beta - t12)
    t2 = gaussq / beta**2
    t3 = d2 / (2.0 * beta) * gaussq
    t4 = t12 * (torch.log1p(beta) if isinstance(beta, torch.Tensor) else math.log1p(beta))
    return t1 - t2 - t3 - t4


class GaussianPosterior(NamedTuple):
    """N(mu, Sigp) stored by the Cholesky factor L of the precision:
    SigpInv = L L^T, Sigp = L^-T L^-1."""

    mu: torch.Tensor          # (d,)
    prec_chol: torch.Tensor   # (d, d) lower: chol(SigpInv)

    @property
    def cov(self) -> torch.Tensor:
        L = self.prec_chol
        Linv = torch.linalg.solve_triangular(L, identity(L.shape[0], L.dtype, L.device),
                                             upper=False)
        return Linv.T @ Linv

    @property
    def prec(self) -> torch.Tensor:
        return self.prec_chol @ self.prec_chol.T


def posterior_from_numpy(arrays, device: torch.device | str = "cuda") -> GaussianPosterior:
    """A ``GaussianPosterior`` from numpy arrays keyed by its field names
    (``mu``, ``prec_chol``; e.g. a JAX posterior's ``_asdict()`` through
    ``np.asarray``). Dtypes are kept; the arrays are copied."""
    return GaussianPosterior(*(torch.tensor(arrays[k], device=device)
                               for k in GaussianPosterior._fields))


def posterior_from_precision(prec, rhs) -> GaussianPosterior:
    """N(prec^-1 rhs, prec^-1) by the Cholesky factor of ``prec``, taken
    with no host read of the info flag (``torch.linalg.cholesky`` reads it,
    which would stop a captured step); ``prec`` is positive definite for
    non-negative weights."""
    L = torch.linalg.cholesky_ex(prec)[0]
    mu = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return GaussianPosterior(mu=mu, prec_chol=L)


def weighted_post(th0, Sig0inv, Siginv, x, w) -> GaussianPosterior:
    """The exact conjugate weighted posterior:
        SigpInv = Sig0inv + (sum_i w_i) Siginv
        mu      = Sigp (Sig0inv th0 + Siginv sum_i w_i x_i)."""
    prec = Sig0inv + torch.sum(w) * Siginv
    rhs = Sig0inv @ th0 + Siginv @ (w @ x)
    return posterior_from_precision(prec, rhs)


def sample_gaussian_prec_from_noise(post: GaussianPosterior, z) -> torch.Tensor:
    """theta = mu + L^-T z for standard normals z (n, d)."""
    return post.mu + torch.linalg.solve_triangular(post.prec_chol.T, z.T, upper=True).T


def sample_gaussian_prec(generator: torch.Generator, post: GaussianPosterior,
                         n_samples: int) -> torch.Tensor:
    """(n, d) draws theta = mu + L^-T z, z ~ N(0, I): covariance Sigp."""
    z = torch.randn((n_samples, post.mu.shape[0]), generator=generator,
                    dtype=post.mu.dtype, device=post.mu.device)
    return sample_gaussian_prec_from_noise(post, z)


def gaussian_KL(mu0, Sig0, mu1, Sig1inv):
    """KL(N(mu0, Sig0) || N(mu1, Sig1)), the second given by its precision."""
    t1 = torch.trace(Sig1inv @ Sig0)
    diff = mu1 - mu0
    t2 = diff @ (Sig1inv @ diff)
    t3 = -torch.linalg.slogdet(Sig1inv)[1] - torch.linalg.slogdet(Sig0)[1]
    return 0.5 * (t1 + t2 + t3 - mu0.shape[0])


def bundle(Siginv, logdetSig, fused: bool | None = None) -> ModelFns:
    """ModelFns over the fixed observation covariance. ``fused`` is taken
    and ignored, as in the reference: there is no Gaussian kernel (the
    projection is one matmul, an elementwise transform and a centring)."""
    del fused

    return ModelFns(
        log_likelihood=lambda pts, thetas: log_likelihood(pts, thetas, Siginv, logdetSig),
        beta_likelihood=lambda pts, thetas, beta: beta_likelihood(pts, thetas, beta, Siginv,
                                                                  logdetSig),
        beta_gradient=lambda pts, thetas, beta: beta_gradient(pts, thetas, beta, Siginv,
                                                              logdetSig),
        grad_z_log_likelihood=lambda pts, thetas: grad_x_log_likelihood(pts, thetas, Siginv),
    )
