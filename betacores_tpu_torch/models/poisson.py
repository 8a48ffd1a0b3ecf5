"""Bayesian Poisson regression with a softplus link (counterpart of
betacores_tpu/models/poisson.py).

    y_n ~ Poisson(f_n),   f_n = softplus(x_n . th),   th ~ N(0, I)

Data rows are z_n = [x_n, y_n] (counts as floats in the last column). The
beta-likelihood is the density-power surrogate

    f_beta(z, th) = (beta+1)/beta p(y|th)^beta - sum_k p(k|th)^(beta+1)

with the mass term a sum over k = 0..k_max, or (``gaussian_mass``) its
closed form under the Poisson ~ N(f, f) approximation. The exact mass term
is a log-sum-exp over an (N, S, k_max+1) block, which the reference's XLA
fuses into its reduction; here it is computed in row chunks of at most
``MASS_CHUNK_ELEMENTS`` elements, so any N runs (N = 2^20, S = 100,
k_max = 64 would be 26 GB in float32 at once).

The Laplace fit uses the expected Hessian (Fisher scoring), negative
definite for every th, where the exact Hessian of a softplus-link GLM is
not.
"""

from __future__ import annotations

import math

import torch

from .base import ModelFns, beta_gradient_from_autodiff, identity
from .logreg import softplus

_LOG2PI = math.log(2.0 * math.pi)

# elements of one row chunk of the exact mass term's (rows, S, k_max+1) block
MASS_CHUNK_ELEMENTS = 1 << 25


def _split(z):
    """(N, D) rows [x, y] -> x: (N, D-1), y: (N,)."""
    return z[..., :-1], z[..., -1]


def _log_softplus(eta):
    """log(softplus(eta)), stable for every eta: softplus underflows near
    eta < -88 in float32, and there log softplus(eta) -> eta."""
    sp = softplus(eta)
    return torch.where(eta < -30.0, eta,
                       torch.log(torch.clamp_min(sp, torch.finfo(eta.dtype).tiny)))


def _log_sigmoid(eta):
    return -softplus(-eta)


def _sig_over_f(eta):
    """sigmoid(eta) / softplus(eta), stable for every eta: both tend to
    exp(eta) as eta -> -inf, where a plain y/f would overflow."""
    return torch.exp(_log_sigmoid(eta) - _log_softplus(eta))


def _ll_rows(y, eta):
    """y log f - f - lgamma(y + 1) for rates f = softplus(eta)."""
    return y * _log_softplus(eta) - softplus(eta) - torch.lgamma(y + 1.0)


def log_likelihood(z, th):
    """(N, S): y log f - f - lgamma(y+1), f = softplus(x.th)."""
    x, y = _split(z)
    return _ll_rows(y[:, None], x @ th.T)


def _exact_mass(logf, f, beta, k_max: int):
    """sum_{k=0..k_max} p(k|f)^(beta+1) for (n, S) rates, as
    exp(logsumexp_k (beta+1) log p(k|f)), in row chunks."""
    ks = torch.arange(k_max + 1, dtype=logf.dtype, device=logf.device)
    lgk = torch.lgamma(ks + 1.0)
    rows = max(1, MASS_CHUNK_ELEMENTS // max(1, logf.shape[1] * (k_max + 1)))
    out = []
    for lo in range(0, logf.shape[0], rows):
        lf, fc = logf[lo:lo + rows, :, None], f[lo:lo + rows, :, None]
        ll_k = ks * lf - fc - lgk                                # (rows, S, K+1)
        out.append(torch.exp(torch.logsumexp((beta + 1.0) * ll_k, dim=-1)))
    return out[0] if len(out) == 1 else torch.cat(out)


def beta_likelihood(z, th, beta, k_max: int = 64, gaussian_mass: bool = False):
    """(N, S) density-power surrogate, positive convention:
        (beta+1)/beta p(y|f)^beta - sum_{k=0..k_max} p(k|f)^(beta+1).
    ``gaussian_mass=True`` takes the mass term's closed form under
    Poisson ~ N(f, f), (2 pi f)^(-beta/2) (1+beta)^(-1/2), accurate for
    rates f >~ 10."""
    x, y = _split(z)
    eta = x @ th.T
    f = softplus(eta)
    logf = _log_softplus(eta)
    ll = y[:, None] * logf - f - torch.lgamma(y + 1.0)[:, None]
    if gaussian_mass:
        log1p_beta = torch.log1p(beta) if isinstance(beta, torch.Tensor) else math.log1p(beta)
        mass = torch.exp(-0.5 * beta * (_LOG2PI + logf) - 0.5 * log1p_beta)
    else:
        mass = _exact_mass(logf, f, beta, k_max)
    return (beta + 1.0) / beta * torch.exp(beta * ll) - mass


def grad_z_log_likelihood(z, th):
    """(N, S, D) gradient w.r.t. the row z = [x, y] (counts relaxed to
    continuous y): d/dx = (y/f - 1) sigmoid(eta) th,
    d/dy = log f - digamma(y+1)."""
    x, y = _split(z)
    eta = x @ th.T
    gx = (y[:, None] * _sig_over_f(eta) - torch.sigmoid(eta))[:, :, None] * th[None, :, :]
    gy = _log_softplus(eta) - torch.special.digamma(y + 1.0)[:, None]
    return torch.cat([gx, gy[:, :, None]], dim=-1)


# --- the weighted joint of one th (the Laplace target) -----------------------


def log_prior(th):
    return -0.5 * th.shape[-1] * _LOG2PI - 0.5 * torch.sum(th * th, dim=-1)


def log_joint(z, th, wts):
    """Weighted log joint for one th (d,) -> scalar, or a batch of
    candidates (K, d) -> (K,)."""
    x, y = _split(z)
    return torch.sum(wts * _ll_rows(y, th @ x.T), dim=-1) + log_prior(th)


def grad_th_log_joint(z, th, wts):
    """(d,): sum_n w_n (y_n/f_n - 1) sigmoid(eta_n) x_n - th."""
    x, y = _split(z)
    eta = x @ th
    c = wts * (y * _sig_over_f(eta) - torch.sigmoid(eta))
    return c @ x - th


def _fisher_weights(z, th, wts):
    x, _ = _split(z)
    eta = x @ th
    return x, wts * torch.sigmoid(eta) * _sig_over_f(eta)


def hess_th_log_joint(z, th, wts):
    """(d, d) expected Hessian (Fisher scoring): -I - sum w s^2/f x x^T."""
    x, c = _fisher_weights(z, th, wts)
    return -identity(th.shape[-1], th.dtype, th.device) - (c[:, None] * x).T @ x


def diag_hess_th_log_joint(z, th, wts):
    x, c = _fisher_weights(z, th, wts)
    return -torch.ones_like(th) - c @ (x * x)


# --- prediction ---------------------------------------------------------------


def predictive_loglik(Zt, thetas):
    """Mean posterior-predictive log-likelihood mean_n log mean_s p(z_n|th_s)."""
    ll = log_likelihood(Zt, thetas)
    return torch.mean(torch.logsumexp(ll, dim=1) - math.log(thetas.shape[0]))


def bundle(k_max: int = 64, gaussian_mass: bool = False,
           fused: bool | None = None) -> ModelFns:
    """``fused`` is taken and ignored, as in the reference: there is no
    Poisson kernel (the reference retired its Pallas mass recurrence for
    XLA's fusion)."""
    del fused

    def blik(z, th, b):
        return beta_likelihood(z, th, b, k_max=k_max, gaussian_mass=gaussian_mass)

    return ModelFns(
        log_likelihood=log_likelihood,
        beta_likelihood=blik,
        beta_gradient=beta_gradient_from_autodiff(blik),
        grad_z_log_likelihood=grad_z_log_likelihood,
    )
