"""Bayesian logistic regression (counterpart of betacores_tpu/models/logreg.py).

Data rows are z_n = y_n * x_n with labels y in {-1, +1}, so

    log p(y_n | x_n, th) = -softplus(-z_n . th)

Prior: th ~ N(0, I). ``beta_likelihood`` uses the positive convention
(beta+1)/beta p^beta - p^(beta+1) - (1-p)^(beta+1).
"""

from __future__ import annotations

import math

import torch

from .base import ModelFns, as_beta, identity, power_gradient

_LOG2PI = math.log(2.0 * math.pi)


def softplus(m: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(m)) in the branch-free form jax.nn.softplus uses
    (``torch.nn.functional.softplus`` switches to the identity above a
    threshold, which would differ from the reference in the low bits).
    max(m, 0) is written 0.5 (m + |m|), the same value bit for bit, so that
    autograd's derivative at m = 0 is sigmoid(0) = 1/2 as jax.nn.softplus's
    (clamp_min passes 1 there and |m| passes 0, which doubled the gradient
    of a log joint at theta = 0)."""
    a = torch.abs(m)
    return 0.5 * (m + a) + torch.log1p(torch.exp(-a))


def log_likelihood(z, th):
    """(N, S): log sigmoid(z_n . th_s) = -softplus(-z_n . th_s)."""
    return -softplus(-(z @ th.T))


def beta_likelihood(z, th, beta):
    """(N, S) beta-divergence surrogate for the Bernoulli likelihood, with
    p^a = exp(-a softplus(m)) and (1-p)^a = exp(-a softplus(-m)),
    m = -z.th, both overflow-free."""
    m = -(z @ th.T)
    sp_pos = softplus(m)    # -log p
    sp_neg = softplus(-m)   # -log(1-p)
    return ((beta + 1.0) / beta * torch.exp(-beta * sp_pos)
            - torch.exp(-(beta + 1.0) * sp_pos)
            - torch.exp(-(beta + 1.0) * sp_neg))


def beta_gradient(z, th, beta):
    """(N, S) d/d(beta) of ``beta_likelihood`` in closed form, with
    sp+- = softplus(+-m):
    e^(-beta sp+) (-1/beta^2 - (beta+1)/beta sp+) + sp+ e^(-(beta+1) sp+)
    + sp- e^(-(beta+1) sp-)."""
    beta = as_beta(beta, z)
    m = -(z @ th.T)
    sp_pos = softplus(m)
    sp_neg = softplus(-m)
    return (power_gradient(beta, -sp_pos)
            + sp_pos * torch.exp(-(beta + 1.0) * sp_pos)
            + sp_neg * torch.exp(-(beta + 1.0) * sp_neg))


def grad_z_log_likelihood(z, th):
    """(N, S, D) gradient w.r.t. the data row z_n: sigmoid(-z.th) * th."""
    return torch.sigmoid(-(z @ th.T))[:, :, None] * th[None, :, :]


def log_prior(th):
    """Standard normal prior; th (..., d) -> (...)."""
    return -0.5 * th.shape[-1] * _LOG2PI - 0.5 * torch.sum(th * th, dim=-1)


def log_joint(z, th, wts):
    """Weighted log joint sum_n w_n log p(z_n | th) + log prior, for one th
    (d,) -> scalar, or a batch of candidates (K, d) -> (K,)."""
    m = -(th @ z.T)
    return torch.sum(wts * -softplus(m), dim=-1) + log_prior(th)


def grad_th_log_joint(z, th, wts):
    """(d,) gradient of the weighted log joint."""
    m = -(z @ th)
    return -th + (wts * torch.sigmoid(m)) @ z


def hess_th_log_joint(z, th, wts):
    """(d, d) Hessian of the weighted log joint (negative definite)."""
    m = -(z @ th)
    s = torch.sigmoid(m)
    c = wts * s * (1.0 - s)
    d = th.shape[-1]
    return -identity(d, th.dtype, th.device) - (c[:, None] * z).T @ z


def diag_hess_th_log_joint(z, th, wts):
    """(d,) diagonal of the Hessian of the weighted log joint."""
    s = torch.sigmoid(-(z @ th))
    c = wts * s * (1.0 - s)
    return -torch.ones_like(th) - c @ (z * z)


# --- prediction --------------------------------------------------------------


def compute_accuracy(Xt, Yt, thetas):
    """Posterior max-log-likelihood predictions, averaged over test points
    and samples: predict +1 where x . th >= 0."""
    scores = Xt @ thetas.T                                   # (Nt, S)
    preds = torch.where(scores >= 0.0, 1.0, -1.0).to(scores.dtype)
    return torch.mean((Yt[:, None] == preds).to(scores.dtype))


def predictive_loglik(Zt, thetas):
    """Mean posterior-predictive log-likelihood on test rows z = y * x:
    mean_n log(mean_s p(z_n | th_s)), through logsumexp."""
    ll = log_likelihood(Zt, thetas)                          # (Nt, S)
    return torch.mean(torch.logsumexp(ll, dim=1) - math.log(thetas.shape[0]))


def bundle() -> ModelFns:
    """The logistic-regression bundle: the likelihoods, the beta-gradient
    (``beta_gradient``, in closed form) and the data gradient, with the
    fused refinement step (ops/kernels.py::logreg_adam_step) and the
    sharded step's partials
    (ops/kernels.py::logreg_shard_step_partials) attached."""
    from ..ops.kernels import logreg_adam_step, logreg_shard_step_partials

    def fused_ll_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true):
        return logreg_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true,
                                use_beta=False)

    def fused_beta_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true):
        return logreg_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true,
                                use_beta=True)

    def fused_ll_shard(xin, z, mu, linv, w, sc, s_true):
        return logreg_shard_step_partials(xin, z, mu, linv, w, sc, s_true,
                                          use_beta=False)

    def fused_beta_shard(xin, z, mu, linv, w, sc, s_true):
        return logreg_shard_step_partials(xin, z, mu, linv, w, sc, s_true,
                                          use_beta=True)

    return ModelFns(log_likelihood=log_likelihood,
                    beta_likelihood=beta_likelihood,
                    beta_gradient=beta_gradient,
                    grad_z_log_likelihood=grad_z_log_likelihood,
                    fused_ll_grad_step=fused_ll_step,
                    fused_beta_grad_step=fused_beta_step,
                    fused_ll_shard_partials=fused_ll_shard,
                    fused_beta_shard_partials=fused_beta_shard)
