"""Bayesian logistic regression (the paper's main experiment, arXiv:2008.13600
§5), as the benchmark needs it.

Rows are z = y x with labels y in {-1, +1}, so log p(y | x, th) =
-softplus(-z . th); the prior is N(0, I). The plain pieces (the data
generator, the reference's log joint, gradient, Hessian and β-likelihood,
the operation counts) import nothing of the program. ``port_model`` and
``port_sampler`` import the program inside the call: they build the system
under test.

The generator is a copy of ``betacores_tpu_torch/data/synthetic.py::
gen_synthetic_logreg`` and ``data/perturb.py::perturb_logreg``
(unstructured corruption), kept here so that a change to the program's
generators cannot move the benchmark's inputs.
"""

from __future__ import annotations

import types

import torch

from ..reference import log_prior

NAME = "logreg"
# operations per likelihood value, each arithmetic or transcendental
# operation counted once (copied from chip_smoke.py::TRANSFORM_OPS, the
# count of csrc/logreg_common.cuh::Likelihood): beta, log
TRANSFORM_OPS = {True: 17, False: 6}
# rows the reference projects at once
BLOCK_ROWS = 1 << 20


def theta_dim(cfg: dict) -> int:
    return int(cfg["d"])


def row_dim(cfg: dict) -> int:
    return int(cfg["d"])


def _softplus(m):
    a = torch.abs(m)
    return torch.clamp_min(m, 0.0) + torch.log1p(torch.exp(-a))


def make_data(gen: torch.Generator, cfg: dict) -> torch.Tensor:
    """The (N, d) contaminated rows Z = y x from ``gen`` (on its device):
    X ~ N(1, I), labels from the logistic model at theta = 1, then
    int(N f_rate) rows (drawn with replacement; a row drawn twice keeps its
    last draw) get N(0, 5^2) noise on d // 2 random columns and as many
    rows, drawn apart, have their labels flipped."""
    n, d, dev, dt = int(cfg["n_rows"]), int(cfg["d"]), gen.device, torch.float32
    X = 1.0 + torch.randn((n, d), generator=gen, dtype=dt, device=dev)
    ps = torch.sigmoid(X @ torch.ones(d, dtype=dt, device=dev))
    u = torch.rand((n,), generator=gen, dtype=dt, device=dev)
    y = torch.where(u <= ps, 1.0, -1.0).to(dt)
    o = int(n * float(cfg["f_rate"]))
    if o:
        idxx = torch.randint(0, n, (o,), generator=gen, device=dev)
        last = torch.full((n,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, idxx, torch.arange(o, device=dev), "amax")
        hit = last >= 0
        idxy = torch.randint(0, n, (o,), generator=gen, device=dev)
        cols = torch.randperm(d, generator=gen, device=dev)[:d // 2]
        noise = 5.0 * torch.randn((o, d // 2), generator=gen, dtype=dt, device=dev)
        X[:, cols] = torch.where(hit[:, None], noise[last.clamp_min(0)], X[:, cols])
        y[idxy] = -y[idxy]
    return y[:, None] * X


# --- the reference's model ---------------------------------------------------


def log_joint(z, th, w):
    """Weighted log joint for one th (d,) or candidates (C, d)."""
    return (w * -_softplus(-(th @ z.T))).sum(-1) + log_prior(th)


def grad(z, th, w):
    return -th + (w * torch.sigmoid(-(z @ th))) @ z


def hess(z, th, w):
    s = torch.sigmoid(-(z @ th))
    c = w * s * (1.0 - s)
    return -torch.eye(th.shape[0], dtype=th.dtype, device=th.device) - (c[:, None] * z).T @ z


def beta_likelihood(z, th, beta):
    """(n, S) uncentred β-likelihood (positive convention):
    (β+1)/β p^β - p^(β+1) - (1-p)^(β+1), p = sigmoid(z . th)."""
    m = -(z @ th.T)
    sp_pos, sp_neg = _softplus(m), _softplus(-m)
    return ((beta + 1.0) / beta * torch.exp(-beta * sp_pos)
            - torch.exp(-(beta + 1.0) * sp_pos) - torch.exp(-(beta + 1.0) * sp_neg))


def reference_model(cfg: dict):
    return types.SimpleNamespace(log_joint=log_joint, grad=grad, hess=hess,
                                 beta_likelihood=beta_likelihood)


# --- the system under test ---------------------------------------------------


def port_model(cfg: dict):
    from betacores_tpu_torch.models import logreg
    return logreg.bundle()


def port_sampler(cfg: dict):
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    return logreg_laplace_sampler(n_newton=int(cfg["n_newton"]))


# --- operation counts ----------------------------------------------------------


def fit_flops(n: int, d: int, n_newton: int) -> int:
    """Float operations of one Laplace fit over n weighted rows, at the
    configured iteration count: n_newton + 1 gradient, Hessian and
    factorisation evaluations (each with two triangular solves and the
    inverse factor the fused step takes), n_newton line searches over 8
    candidates, and the first log joint."""
    grad_ = 4 * n * d + 5 * n + d
    hess_ = 3 * n * d + 2 * n * d * d + 7 * n + 2 * d * d
    factor = d ** 3 // 3 + d ** 3 + 8 * d * d + 2 * d
    search = 8 * (2 * n * d + 7 * n + 2 * n + 2 * d) + 2 * 8 * d
    first = 2 * n * d + 9 * n + 2 * d
    return (n_newton + 1) * (grad_ + hess_ + factor) + n_newton * search + first


def project_flops(n: int, S: int, d: int, use_beta: bool = True) -> int:
    """A centred projection of n rows under S samples: per value the dot
    product, the transform and the centring (chip_smoke.py::step_bound)."""
    return n * S * (2 * d + TRANSFORM_OPS[use_beta] + 2)


def sample_flops(S: int, d: int) -> int:
    return 2 * S * d * d + S * d


def selection_flops(cfg: dict, route: dict, m_before: int, m: int) -> int:
    """Float operations one selection needs with m_before live buffer rows
    in its select and m in its refinement: the select (fit, samples,
    projections of the candidates and the buffer, scores, the group sums)
    and T refinement steps (fit, samples, projections of the step's rows
    and the buffer, residual, gradient, Adam)."""
    d, S, N = int(cfg["d"]), int(cfg["projection_dim"]), int(cfg["n_rows"])
    nn = int(cfg["n_newton"])
    n_sel = N if route["n_select"] is None else route["n_select"]
    sel = (fit_flops(m_before, d, nn) + sample_flops(S, d)
           + project_flops(n_sel + m_before, S, d)
           + n_sel * S + 2 * m_before * S            # residual
           + 5 * n_sel * S + 3 * n_sel               # norms and scores
           + 5 * m_before * S)                       # the buffer's scores
    if route["groups"]:
        sel += N * S
    n_opt = N if route["n_opt"] is None else route["n_opt"]
    step = (fit_flops(m, d, nn) + sample_flops(S, d) + project_flops(n_opt + m, S, d)
            + n_opt * S + 2 * m * S + 2 * m * S + m + 12 * m)
    return sel + route["opt_itrs"] * step


def adam_step_bound(cfg: dict, route: dict, m: int, peaks) -> dict:
    """K1's bound (chip_smoke.py::step_bound at the cell's shapes): the
    packed rows are the subsample padded to 8 and the buffer padded to 128;
    live rows are the subsample and the m live slots."""
    d, S = int(cfg["d"]), int(cfg["projection_dim"])
    n_sub = route["n_opt"]
    M_pad = -(-int(route["buffer_slots"]) // 128) * 128
    R = -(-n_sub // 8) * 8 + M_pad
    return peaks.step_bound(R, d, S, M_pad, n_sub + m, m, TRANSFORM_OPS[True])
