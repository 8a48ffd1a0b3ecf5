"""Bayesian linear regression with known noise variance (counterpart of
betacores_tpu/models/linreg.py).

Data rows are z_n = [x_n, y_n] (features with y appended as the last
column); the likelihood is y_n | x_n, th ~ N(x_n . th, sigsq). The weighted
posterior is conjugate:

    SigpInv = Sig0inv + X^T diag(w) X / sigsq
    mu      = Sigp (Sig0inv th0 + sum_n w_n y_n x_n / sigsq)

with the correct triangular-factor order (models/gaussian.py).
"""

from __future__ import annotations

import math

import torch

from .base import ModelFns, beta_gradient_from_autodiff
from .gaussian import GaussianPosterior, posterior_from_precision


def _split(z):
    return z[:, :-1], z[:, -1]


def _resid_sq(z, th):
    """(N, S) squared residuals (y - x.th)^2 in the factored form: the
    reference's expansion y^2 - 2 pred y + pred^2 cancels catastrophically
    in float32 when |y| >> |resid|, as the JAX module documents."""
    x, y = _split(z)
    return (y[:, None] - x @ th.T) ** 2


def log_likelihood(z, th, sigsq):
    """(N, S): log N(y_n | x_n . th_s, sigsq)."""
    return -0.5 * math.log(2.0 * math.pi * sigsq) - _resid_sq(z, th) / (2.0 * sigsq)


def beta_likelihood(z, th, beta, sigsq):
    """(N, S) beta-divergence surrogate of the Gaussian regression
    likelihood, positive convention:
        (2 pi sigsq)^(-beta/2) [(beta+1)/beta exp(-beta (y - x.th)^2 / (2 sigsq))
                                - 1/sqrt(1+beta)]."""
    cnst = (2.0 * math.pi * sigsq) ** (-0.5 * beta)
    return cnst * ((beta + 1.0) / beta * torch.exp(-beta / (2.0 * sigsq) * _resid_sq(z, th))
                   - 1.0 / (1.0 + beta) ** 0.5)


def grad_z_log_likelihood(z, th, sigsq):
    """(N, S, D) gradient w.r.t. the whole row z = [x, y]:
    d/dx = (y - x.th)/sigsq * th and d/dy = -(y - x.th)/sigsq (the true
    sign; the original reference has +1 for the y column)."""
    x, y = _split(z)
    r = (y[:, None] - x @ th.T) / sigsq
    th_aug = torch.cat([th, -torch.ones((th.shape[0], 1), dtype=th.dtype,
                                        device=th.device)], dim=1)
    return r[:, :, None] * th_aug[None, :, :]


def weighted_post(th0, Sig0inv, sigsq, z, w) -> GaussianPosterior:
    """The exact conjugate weighted posterior over the regression weights."""
    x, y = _split(z)
    prec = Sig0inv + (w[:, None] * x).T @ x / sigsq
    rhs = Sig0inv @ th0 + ((w * y) @ x) / sigsq
    return posterior_from_precision(prec, rhs)


def bundle(sigsq) -> ModelFns:
    def _blik(pts, thetas, beta):
        return beta_likelihood(pts, thetas, beta, sigsq)

    return ModelFns(
        log_likelihood=lambda pts, thetas: log_likelihood(pts, thetas, sigsq),
        beta_likelihood=_blik,
        beta_gradient=beta_gradient_from_autodiff(_blik),
        grad_z_log_likelihood=lambda pts, thetas: grad_z_log_likelihood(pts, thetas, sigsq),
    )
