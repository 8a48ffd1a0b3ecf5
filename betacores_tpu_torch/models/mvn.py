"""Multivariate Gaussian with unknown covariance, under a
Normal-Inverse-Wishart prior (counterpart of betacores_tpu/models/mvn.py).

  prior      (mu, Sigma) ~ NIW(mu0, kappa0, Psi0, nu0)
  posterior  the conjugate weighted NIW update (``weighted_post``)
  samples    exact NIW draws by the Bartlett decomposition, packed as rows
             th = [mu (d), vec(L) (d*d)] with L = chol(Lambda) and
             Lambda = Sigma^-1, so every likelihood is a triangular matvec.

``sample_niw`` is split in two, so that another implementation's draws can
be fed in: ``draw_niw`` takes the standard gamma, the subdiagonal normals
and the mean's normals from a ``torch.Generator``, and
``sample_niw_from_draws`` transforms them. The gamma shapes
0.5 (nu - i) depend on the posterior, so a build cannot draw a pass's
noise ahead of the weights: the builders run this sampler on their
per-step-draw route (coresets/incremental.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .base import ModelFns, Prior, as_beta, identity, power_gradient

_LOG2PI = math.log(2.0 * math.pi)


def pack(mu, L):
    """(S, d), (S, d, d) -> (S, d + d*d) packed parameter rows."""
    S, d = mu.shape
    return torch.cat([mu, L.reshape(S, d * d)], dim=1)


def unpack(thetas, d: int):
    """(S, d + d*d) -> mu (S, d), L (S, d, d) precision Cholesky."""
    return thetas[:, :d], thetas[:, d:].reshape(thetas.shape[0], d, d)


def _half_logdet(L):
    """(S,): log |Lambda|^(1/2) = sum log diag L."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def _whitened(z, mu, L):
    """(N, S, d): L^T (z_n - mu_s), the factored form. The expanded
    vec(zz^T) . vec(Lambda) form cancels catastrophically in float32, as
    the JAX module measured."""
    diff = z[:, None, :] - mu[None, :, :]
    return torch.einsum("nsd,sde->nse", diff, L)


def log_likelihood(z, thetas):
    """(N, S): log N(z_n | mu_s, Sigma_s) by the precision Cholesky."""
    d = z.shape[1]
    mu, L = unpack(thetas, d)
    y = _whitened(z, mu, L)
    quad = torch.sum(y * y, dim=-1)
    return -0.5 * d * _LOG2PI + _half_logdet(L)[None, :] - 0.5 * quad


def beta_likelihood(z, thetas, beta):
    """(N, S) density-power surrogate, positive convention:
    (beta+1)/beta p^beta - (2 pi)^(-beta d/2) |Sigma|^(-beta/2) (1+beta)^(-d/2)."""
    d = z.shape[1]
    _, L = unpack(thetas, d)
    ll = log_likelihood(z, thetas)
    log1p_beta = torch.log1p(beta) if isinstance(beta, torch.Tensor) else math.log1p(beta)
    log_mass = beta * (_half_logdet(L) - 0.5 * d * _LOG2PI) - 0.5 * d * log1p_beta
    return (beta + 1.0) / beta * torch.exp(beta * ll) - torch.exp(log_mass)[None, :]


def beta_gradient(z, thetas, beta):
    """(N, S) d/d(beta) of ``beta_likelihood`` in closed form: with
    h = log |Lambda|^(1/2) - d/2 log 2 pi, p^beta ((beta+1)/beta log p -
    1/beta^2) - exp(beta h - d/2 log(1+beta)) (h - d / (2 (1+beta)))."""
    beta = as_beta(beta, z)
    d = z.shape[1]
    _, L = unpack(thetas, d)
    h = _half_logdet(L) - 0.5 * d * _LOG2PI
    mass = torch.exp(beta * h - 0.5 * d * torch.log1p(beta))
    dmass = mass * (h - 0.5 * d / (1.0 + beta))
    return power_gradient(beta, log_likelihood(z, thetas)) - dmass[None, :]


def grad_z_log_likelihood(z, thetas):
    """(N, S, d): d/dz log N(z | mu_s, Sigma_s) = -Lambda (z - mu)."""
    d = z.shape[1]
    mu, L = unpack(thetas, d)
    return -torch.einsum("sde,nse->nsd", L, _whitened(z, mu, L))


class NIWPosterior(NamedTuple):
    mu: torch.Tensor     # (d,)
    kappa: torch.Tensor  # 0-d
    Psi: torch.Tensor    # (d, d) scale matrix
    nu: torch.Tensor     # 0-d degrees of freedom


def posterior_from_numpy(arrays, device: torch.device | str = "cuda") -> NIWPosterior:
    """An ``NIWPosterior`` from numpy arrays keyed by its field names
    (``mu``, ``kappa``, ``Psi``, ``nu``; e.g. a JAX posterior's
    ``_asdict()`` through ``np.asarray``). Dtypes are kept; the arrays are
    copied."""
    return NIWPosterior(*(torch.tensor(arrays[k], device=device) for k in NIWPosterior._fields))


def weighted_post(mu0, kappa0, Psi0, nu0, x, w) -> NIWPosterior:
    """The exact conjugate weighted NIW update from the weighted sufficient
    statistics W = sum w, xbar = sum w x / W, scatter =
    sum w (x - xbar)(x - xbar)^T. W = 0 gives the prior."""
    w = w.to(x.dtype)
    W = torch.sum(w)
    xbar = (w @ x) / torch.clamp_min(W, 1e-12)
    diff = x - xbar
    scatter = torch.einsum("n,nd,ne->de", w, diff, diff)
    kappa_n = kappa0 + W
    mu_n = (kappa0 * mu0 + W * xbar) / kappa_n
    dm = xbar - mu0
    Psi_n = Psi0 + scatter + (kappa0 * W / kappa_n) * torch.outer(dm, dm)
    return NIWPosterior(mu=mu_n, kappa=kappa_n, Psi=Psi_n, nu=nu0 + W)


def draw_niw(generator: torch.Generator, post: NIWPosterior, n: int):
    """The draws of ``n`` NIW samples: (gam (n, d) standard gamma draws of
    shape 0.5 (nu - i), off (n, d, d) and xi (n, d) standard normals)."""
    d, dtype, dev = post.mu.shape[0], post.mu.dtype, post.mu.device
    i = torch.arange(d, dtype=post.nu.dtype, device=dev)
    shape = (0.5 * (post.nu - i)).expand(n, d).contiguous()
    gam = torch._standard_gamma(shape, generator=generator)
    off = torch.randn((n, d, d), generator=generator, dtype=dtype, device=dev)
    xi = torch.randn((n, d), generator=generator, dtype=dtype, device=dev)
    return gam, off, xi


def sample_niw_from_draws(post: NIWPosterior, gam, off, xi):
    """(n, d + d*d) NIW samples packed as [mu, vec(chol(Lambda))] from the
    draws of ``draw_niw``. Bartlett: Lambda ~ Wishart(nu, Psi^-1) has the
    factor L = C A, C = chol(Psi^-1), A lower-triangular with
    A_ii^2 = 2 gam_i ~ chi2(nu - i) and subdiagonal ``off``; then
    mu = mu_n + L^-T xi / sqrt(kappa)."""
    d, dtype = post.mu.shape[0], post.mu.dtype
    eye = identity(d, dtype, post.mu.device)
    P = torch.linalg.cholesky_ex(post.Psi)[0]
    Pinv = torch.linalg.solve_triangular(P, eye, upper=False)
    C = torch.linalg.cholesky_ex(Pinv.T @ Pinv)[0]           # chol(Psi^-1)
    A = torch.tril(off, -1) + torch.diag_embed(torch.sqrt(gam * 2.0)).to(dtype)
    L = torch.einsum("de,nef->ndf", C, A)
    v = torch.linalg.solve_triangular(L.transpose(-1, -2), xi[..., None], upper=True)[..., 0]
    mu = post.mu[None, :] + v / torch.sqrt(post.kappa)
    return pack(mu.to(dtype), L.to(dtype))


def sample_niw(generator: torch.Generator, post: NIWPosterior, n: int):
    """(n, d + d*d) exact NIW draws packed as [mu, vec(chol(Lambda))]."""
    return sample_niw_from_draws(post, *draw_niw(generator, post, n))


def _multigammaln(a, d: int):
    return torch.special.multigammaln(a, d)


def _multidigamma(a, d: int):
    i = torch.arange(d, dtype=a.dtype, device=a.device)
    return torch.sum(torch.special.digamma(a - 0.5 * i))


def niw_logpdf(th_packed, post: NIWPosterior):
    """log NIW density of one packed [mu, vec(chol(Lambda))] row in the
    (mu, Sigma) parameterisation, with no Jacobian of the packing (compare
    only ratios of the same packing)."""
    d = post.mu.shape[0]
    mu, L = unpack(th_packed[None, :], d)
    mu, L = mu[0], L[0]
    Lam = L @ L.T
    half_logdet_lam = torch.sum(torch.log(torch.diagonal(L)))
    dm = mu - post.mu
    log_n = (-0.5 * d * _LOG2PI + 0.5 * d * torch.log(post.kappa)
             + half_logdet_lam - 0.5 * post.kappa * (dm @ Lam @ dm))
    logdet_psi = torch.linalg.slogdet(post.Psi)[1]
    log_iw = (0.5 * post.nu * logdet_psi - 0.5 * post.nu * d * math.log(2.0)
              - _multigammaln(0.5 * post.nu, d)
              + (post.nu + d + 1.0) * half_logdet_lam
              - 0.5 * torch.trace(post.Psi @ Lam))
    return log_n + log_iw


def niw_kl(p: NIWPosterior, q: NIWPosterior):
    """Closed-form KL(NIW_p || NIW_q): the conditional normal's expected KL
    plus the Wishart KL of the precisions."""
    d = p.mu.shape[0]
    dm = p.mu - q.mu
    Pinv = torch.linalg.inv(p.Psi)
    kl_n = 0.5 * (d * q.kappa / p.kappa - d + d * torch.log(p.kappa / q.kappa)
                  + q.kappa * p.nu * (dm @ Pinv @ dm))
    logdet_qp = torch.linalg.slogdet(q.Psi @ Pinv)[1]
    kl_w = (0.5 * q.nu * (-logdet_qp)
            + 0.5 * p.nu * (torch.trace(q.Psi @ Pinv) - d)
            + _multigammaln(0.5 * q.nu, d) - _multigammaln(0.5 * p.nu, d)
            + 0.5 * (p.nu - q.nu) * _multidigamma(0.5 * p.nu, d))
    return kl_n + kl_w


def predictive_logpdf(x, post: NIWPosterior):
    """(N,) posterior-predictive log density, the multivariate Student-t
    t_{nu-d+1}(mu, Psi (kappa+1) / (kappa (nu-d+1)))."""
    d = post.mu.shape[0]
    v = post.nu - d + 1.0
    P = torch.linalg.cholesky(post.Psi * (post.kappa + 1.0) / (post.kappa * v))
    y = torch.linalg.solve_triangular(P, (x - post.mu[None, :]).T, upper=False).T
    quad = torch.sum(y * y, dim=-1)
    half_logdet = torch.sum(torch.log(torch.diagonal(P)))
    return (torch.lgamma(0.5 * (v + d)) - torch.lgamma(0.5 * v)
            - 0.5 * d * torch.log(v * math.pi) - half_logdet
            - 0.5 * (v + d) * torch.log1p(quad / v))


class MvnNiwSampler:
    """Exact weighted NIW posterior draws for the coreset projectors:
    ``sampler(generator, n, wts, pts, aux) -> (samples, aux)``. It has no
    noise split (``draw_noise``/``from_noise``), as in the reference, so
    the builders run it on their per-step-draw route."""

    def __init__(self, mu0, kappa0, Psi0, nu0):
        mu0 = torch.as_tensor(mu0)
        self.prior = Prior(mu0, *(torch.as_tensor(v, dtype=mu0.dtype) for v in (kappa0, Psi0, nu0)))

    def posterior(self, wts, pts) -> NIWPosterior:
        dt = torch.promote_types(self.prior.dtype, pts.dtype)
        return weighted_post(*self.prior.at(dt, pts.device), pts.to(dt), wts.to(dt))

    def __call__(self, generator, n, wts, pts, aux):
        return sample_niw(generator, self.posterior(wts, pts), n), aux


def mvn_niw_sampler(mu0, kappa0, Psi0, nu0) -> MvnNiwSampler:
    """The exact weighted NIW posterior sampler of a prior."""
    return MvnNiwSampler(mu0, kappa0, Psi0, nu0)


def bundle(d: int) -> ModelFns:
    """ModelFns of the unknown-covariance Gaussian; parameter rows are
    (d + d*d)-dim packed [mu, vec(chol(Sigma^-1))] (pass
    ``theta_dim=d + d*d`` to the projectors)."""
    del d
    return ModelFns(
        log_likelihood=log_likelihood,
        beta_likelihood=beta_likelihood,
        beta_gradient=beta_gradient,
        grad_z_log_likelihood=grad_z_log_likelihood,
    )
