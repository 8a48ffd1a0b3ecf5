"""Evaluation metrics (counterpart of betacores_tpu/evaluation/metrics.py):
the reverse and forward KL of two Gaussian posteriors, the posterior-averaged
RMSE and predictive NLL of (neural-)linear regression, and the logistic
posterior's test accuracy and predictive log-likelihood."""

from __future__ import annotations

import math

import torch

from ..models.gaussian import GaussianPosterior, gaussian_KL
from ..models.logreg import compute_accuracy, predictive_loglik


def reverse_forward_kl(post_w: GaussianPosterior, post_full: GaussianPosterior):
    """(reverse, forward) KL between a coreset posterior and the full
    posterior, both precision-Cholesky Gaussians."""
    rkl = gaussian_KL(post_w.mu, post_w.cov, post_full.mu, post_full.prec)
    fkl = gaussian_KL(post_full.mu, post_full.cov, post_w.mu, post_w.prec)
    return rkl, fkl


def regression_rmse_nll(Xt, yt, thetas, sigsq):
    """Posterior-averaged test RMSE and Gaussian predictive NLL of
    (neural-)linear regression; thetas (S, d), yt (Nt,) or (Nt, 1)."""
    yt = yt.reshape(-1)
    preds = Xt @ thetas.T
    rmse = torch.sqrt(torch.mean((preds.mean(dim=1) - yt) ** 2))
    ll = -0.5 * math.log(2 * math.pi * sigsq) - (yt[:, None] - preds) ** 2 / (2 * sigsq)
    nll = -torch.mean(torch.logsumexp(ll, dim=1) - math.log(thetas.shape[0]))
    return rmse, nll


__all__ = ["reverse_forward_kl", "regression_rmse_nll", "compute_accuracy",
           "predictive_loglik", "gaussian_KL"]
