"""Bayesian multiclass (softmax) logistic regression (counterpart of
betacores_tpu/models/multiclass.py).

Data rows are z_n = [x_n, y_n] with the class label y in {0..K-1} stored as
a float in the last column. Parameters are a packed theta of dim K*d
(row-major (K, d)).

    log p(y | x, th) = x . th_y - logsumexp_k(x . th_k)

Prior: th ~ N(0, I) over all K*d coordinates. ``beta_likelihood`` is the
density-power surrogate in the positive convention,
(beta+1)/beta * p_y^beta - sum_k p_k^(beta+1), computed from
log-probabilities. The functions are built per class count by the
``make_*`` factories, as in the reference; ``bundle`` attaches the
hand-written projection kernel (ops/kernels.py::multiclass_projection).
"""

from __future__ import annotations

import math

import torch

from .base import ModelFns, beta_gradient_from_autodiff, identity

_LOG2PI = math.log(2.0 * math.pi)


def _split(z):
    """(N, D) rows -> ((N, d) features, (N,) int64 labels); the float label
    is truncated toward zero, as the reference's int32 cast does."""
    return z[:, :-1], z[:, -1].to(torch.int64)


def _log_probs(x, th, n_classes: int):
    """(N, S, K) log softmax probabilities for packed thetas (S, K*d)."""
    S, d = th.shape[0], x.shape[1]
    logits = torch.einsum("nd,skd->nsk", x, th.reshape(S, n_classes, d))
    return torch.log_softmax(logits, dim=-1)


def _pick(lp, y):
    """lp[n, s, y_n] for (N, S, K) log-probabilities -> (N, S)."""
    idx = y[:, None, None].expand(lp.shape[0], lp.shape[1], 1)
    return torch.gather(lp, 2, idx)[:, :, 0]


def make_log_likelihood(n_classes: int):
    def log_likelihood(z, th):
        """(N, S): log p(y_n | x_n, th_s)."""
        x, y = _split(z)
        return _pick(_log_probs(x, th, n_classes), y)

    return log_likelihood


def make_beta_likelihood(n_classes: int):
    def beta_likelihood(z, th, beta):
        """(N, S) density-power surrogate, positive convention:
        (beta+1)/beta * p_y^beta - sum_k p_k^(1+beta)."""
        x, y = _split(z)
        lp = _log_probs(x, th, n_classes)               # (N, S, K)
        lp_y = _pick(lp, y)
        mass = torch.exp(torch.logsumexp((1.0 + beta) * lp, dim=2))
        return (beta + 1.0) / beta * torch.exp(beta * lp_y) - mass

    return beta_likelihood


def make_grad_z_log_likelihood(n_classes: int):
    def grad_z_log_likelihood(z, th):
        """(N, S, D) gradient w.r.t. the data row: (e_y - p) . Th over the
        features; the label coordinate gets 0 (labels are discrete)."""
        x, y = _split(z)
        S, d = th.shape[0], x.shape[1]
        lp = _log_probs(x, th, n_classes)                  # (N, S, K)
        onehot = torch.nn.functional.one_hot(y, n_classes).to(lp.dtype)
        coef = -torch.exp(lp) + onehot[:, None, :]           # e_y - p
        gx = torch.einsum("nsk,skd->nsd", coef, th.reshape(S, n_classes, d))
        return torch.cat([gx, torch.zeros_like(gx[:, :, :1])], dim=2)

    return grad_z_log_likelihood


def log_prior(th):
    """Standard normal prior; th (..., K*d) -> (...)."""
    return -0.5 * th.shape[-1] * _LOG2PI - 0.5 * torch.sum(th * th, dim=-1)


def _logits(x, th, n_classes: int):
    """(..., N, K) logits for one packed theta (K*d,) or a batch
    (C, K*d): x @ Th^T per candidate, the reference's single-theta form."""
    Th = th.reshape(*th.shape[:-1], n_classes, x.shape[1])
    return torch.matmul(x, Th.transpose(-1, -2))


def make_log_joint(n_classes: int):
    def log_joint(z, th, wts):
        """Weighted log joint sum_n w_n log p(y_n | x_n, th) + log prior, for
        one packed theta (K*d,) -> scalar, or a batch of candidates
        (C, K*d) -> (C,)."""
        x, y = _split(z)
        lp = torch.log_softmax(_logits(x, th, n_classes), dim=-1)   # (..., N, K)
        idx = y.expand(*lp.shape[:-1])[..., None]
        ll = torch.gather(lp, -1, idx)[..., 0]
        return torch.sum(wts * ll, dim=-1) + log_prior(th)

    return log_joint


def make_grad_th_log_joint(n_classes: int):
    def grad_th_log_joint(z, th, wts):
        """(K*d,) analytic gradient: -th + sum_n w_n (e_{y_n} - p_n) (x) x_n."""
        x, y = _split(z)
        p = torch.softmax(_logits(x, th, n_classes), dim=-1)        # (N, K)
        coef = torch.nn.functional.one_hot(y, n_classes).to(p.dtype) - p
        g = (wts[:, None] * coef).T @ x                             # (K, d)
        return -th + g.reshape(-1)

    return grad_th_log_joint


def make_hess_th_log_joint(n_classes: int):
    def hess_th_log_joint(z, th, wts):
        """(K*d, K*d) analytic Hessian
        -I - sum_n w_n (diag(p_n) - p_n p_n^T) (x) x_n x_n^T
        (negative definite: softmax log-likelihoods are concave)."""
        x, _ = _split(z)
        K, d = n_classes, x.shape[1]
        p = torch.softmax(_logits(x, th, K), dim=-1)                # (N, K)
        Wp = wts[:, None, None] * (torch.diag_embed(p) - p[:, :, None] * p[:, None, :])
        H = torch.einsum("nkl,nd,ne->kdle", Wp, x, x)               # (K, d, K, d)
        return -identity(K * d, th.dtype, th.device) - H.reshape(K * d, K * d)

    return hess_th_log_joint


# --- prediction --------------------------------------------------------------


def predictive_probs(Xt, thetas, n_classes: int):
    """(Nt, K) posterior-mean class probabilities."""
    lp = _log_probs(Xt, thetas, n_classes)               # (Nt, S, K)
    return torch.exp(torch.logsumexp(lp, dim=1) - math.log(thetas.shape[0]))


def compute_accuracy(Xt, Yt, thetas, n_classes: int):
    preds = torch.argmax(predictive_probs(Xt, thetas, n_classes), dim=1)
    return torch.mean((preds == Yt.to(torch.int64)).to(Xt.dtype))


def predictive_loglik(Zt, thetas, n_classes: int):
    """Mean posterior-predictive log-likelihood on test rows z = [x, y]."""
    ll = make_log_likelihood(n_classes)(Zt, thetas)      # (Nt, S)
    return torch.mean(torch.logsumexp(ll, dim=1) - math.log(thetas.shape[0]))


def bundle(n_classes: int, fused: bool | None = None) -> ModelFns:
    """ModelFns for a K-class softmax family (packed parameter rows of dim
    K*d). The centred projections go through the hand-written kernel
    (ops/kernels.py::multiclass_projection: the CUDA kernel on a card, its
    plain version on the CPU), which the projection engine takes for row
    blocks of at least FUSED_MIN_ROWS. ``fused=False`` leaves it off, so
    every projection is the plain composition. ``beta_gradient`` is the
    forward-mode derivative of the plain ``beta_likelihood``, never of
    the kernel."""
    if n_classes < 2:
        raise ValueError("n_classes must be >= 2")
    fused_ll = fused_beta = None
    if fused is None or fused:
        from ..ops.kernels import multiclass_projection

        # the kernel computes in float32: cast in, and back to the rows'
        # dtype out, as the reference's fused projection does
        f32 = torch.float32

        def fused_ll(pts, th):
            return multiclass_projection(pts.to(f32), th.to(f32), n_classes, 1.0,
                                         use_beta=False).to(pts.dtype)

        def fused_beta(pts, th, beta):
            if isinstance(beta, torch.Tensor):
                beta = beta.to(f32)
            return multiclass_projection(pts.to(f32), th.to(f32), n_classes, beta,
                                         use_beta=True).to(pts.dtype)

    beta_likelihood = make_beta_likelihood(n_classes)
    return ModelFns(log_likelihood=make_log_likelihood(n_classes),
                    beta_likelihood=beta_likelihood,
                    beta_gradient=beta_gradient_from_autodiff(beta_likelihood),
                    grad_z_log_likelihood=make_grad_z_log_likelihood(n_classes),
                    fused_ll_projection=fused_ll,
                    fused_beta_projection=fused_beta)
