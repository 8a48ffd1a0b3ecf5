"""Accelerated iterative hard thresholding for Bayesian coresets
(counterpart of betacores_tpu/snnls/iht.py; "Bayesian Coresets: Revisiting
the Nonconvex Optimization Perspective", arXiv:2007.00715).

In place of growing a support one column a step, it attacks

    min_w ||b - A w||^2   s.t.   ||w||_0 <= K,  w >= 0

with projected gradient and momentum:

  g      = A^T (b - A z)
  eta    = ||g_U||^2 / ||A g_U||^2 on the union U of the iterate's support
           and the top-K positive gradient coordinates (exact line search)
  w'     = P_{K,+}(z + eta g)          non-negative hard threshold
  debias: five exact projected-gradient steps on supp(w')
  z'     = w' + tau (w' - w_prev)      tau the exact momentum step in [0, 1],
                                       0 after a step that did not improve

The non-negative top-K projection ranks by a stable sort (ties go to the
lower index). ``build(itrs)`` adds ``itrs`` to the budget K and re-solves
from the current iterate, keeping the best iterate, so the error never
rises across calls; ``build_trace(itrs)`` records the solution at budgets
K+1..K+itrs (row m - 1 at total budget m, as the greedy solvers' trace).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import errors
from .base import SparseNNLS
from .base import build as greedy_build
from .giga import giga_precompute, giga_step


def project_nonneg_topk(x: torch.Tensor, K: int) -> torch.Tensor:
    """Euclidean projection onto {w >= 0, ||w||_0 <= K}: clip at 0 and keep
    the K largest (a stable rank: exact ties go to the lower index)."""
    xp = torch.clamp_min(x, 0.0)
    order = torch.sort(-xp, stable=True).indices
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(x.shape[0], device=x.device))
    return torch.where(rank < K, xp, 0.0)


class IHTState(NamedTuple):
    w: torch.Tensor
    w_prev: torch.Tensor
    z: torch.Tensor
    best_w: torch.Tensor
    best_err: torch.Tensor


def _exact_step(A, g, mask):
    """The exact line-search step on the masked subspace,
    eta = ||g_m||^2 / ||A g_m||^2 (0 for a zero gradient), and g_m."""
    gm = torch.where(mask, g, 0.0)
    num = torch.sum(gm * gm)
    Agm = A @ gm
    den = torch.sum(Agm * Agm)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0), gm


def aiht_solve(A: torch.Tensor, b: torch.Tensor, K: int, w0: torch.Tensor,
               inner_itrs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``inner_itrs`` accelerated IHT steps at budget K from ``w0``; returns
    (best_w, best_err). It iterates in v = ||a_i|| w_i over unit columns
    (the constraints are invariant under that rescale, and the steps far
    better conditioned)."""
    norms = torch.sqrt(torch.sum(A * A, dim=0))
    safe = torch.where(norms > 0, norms, 1.0)
    A = A / safe[None, :]
    w0 = project_nonneg_topk(w0 * safe, K)
    st = IHTState(w=w0, w_prev=w0, z=w0, best_w=w0,
                  best_err=torch.linalg.norm(A @ w0 - b))
    for _ in range(int(inner_itrs)):
        g = A.T @ (b - A @ st.z)
        # the union support: the iterate's and the top-K positive gradient's
        mask = (st.z > 0) | (project_nonneg_topk(g, K) > 0)
        eta, _ = _exact_step(A, g, mask)
        w_new = project_nonneg_topk(st.z + eta * g, K)
        supp = w_new > 0
        for _ in range(5):
            eta2, g2m = _exact_step(A, A.T @ (b - A @ w_new), supp)
            w_new = torch.clamp_min(w_new + eta2 * g2m, 0.0)
        dw = w_new - st.w
        Adw = A @ dw
        den_m = torch.sum(Adw * Adw)
        err = torch.linalg.norm(A @ w_new - b)
        tau = torch.where(den_m > 0,
                          torch.sum((b - A @ w_new) * Adw) / torch.where(den_m > 0, den_m, 1.0),
                          0.0)
        tau = torch.where(err <= st.best_err, torch.clamp(tau, 0.0, 1.0), 0.0)
        better = err < st.best_err
        st = IHTState(w=w_new, w_prev=st.w, z=w_new + tau * dw,
                      best_w=torch.where(better, w_new, st.best_w),
                      best_err=torch.minimum(err, st.best_err))
    return st.best_w / safe, st.best_err


def aiht_solve_hybrid(A: torch.Tensor, b: torch.Tensor, K: int, w0: torch.Tensor,
                      inner_itrs: int, tol=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GIGA-seeded A-IHT: K greedy GIGA steps from scratch, the better of
    that and ``w0``, then IHT. Never worse than GIGA at equal sparsity (the
    best-so-far includes the seed), while IHT may still swap support
    columns, which a greedy build never does."""
    if tol is None:
        tol = errors.TOL
    pre = giga_precompute(A, b)
    err_fn = lambda w: torch.linalg.norm(A @ w - b)
    gst = greedy_build(lambda w: giga_step(pre, w, tol), err_fn, torch.zeros_like(w0), K)
    w_init = torch.where(err_fn(gst.w) < err_fn(w0), gst.w, w0)
    return aiht_solve(A, b, K, w_init, inner_itrs)


class AccIHT(SparseNNLS):
    """The shared solver surface over A-IHT. ``build(itrs)`` grows the
    budget by ``itrs`` and re-solves; ``optimize()`` is the inherited exact
    re-solve on the final support. ``init='giga'`` (the default) seeds every
    solve with a greedy GIGA run; ``init='zero'`` is the paper's pure
    A-IHT."""

    def __init__(self, A, b, max_support: int | None = None, inner_itrs: int = 100,
                 init: str = "giga", device=None):
        if init not in ("giga", "zero"):
            raise ValueError(f"init must be 'giga' or 'zero', got {init!r}")
        self.inner_itrs = int(inner_itrs)
        self.init = init
        super().__init__(A, b, max_support=max_support, device=device)
        if init == "giga" and bool((torch.sum(self.A * self.A, dim=0) == 0).any()):
            raise ValueError("AccIHT(init='giga'): A must not have zero columns")

    def _solve(self, K: int, w0: torch.Tensor) -> torch.Tensor:
        if self.init == "giga":
            return aiht_solve_hybrid(self.A, self.b, K, w0, self.inner_itrs, errors.TOL)[0]
        return aiht_solve(self.A, self.b, K, w0, self.inner_itrs)[0]

    def reset(self) -> None:
        super().reset()
        self.K = 0

    def build(self, itrs: int) -> None:
        if self.reached_numeric_limit:
            self.log.warning("numeric limit already reached; returning")
            return
        if self.A.numel() == 0:
            self.log.warning("no data; returning")
            return
        self.K = min(self.K + int(itrs), self.max_support)
        # the solve's best-so-far starts at the warm start, so the error
        # never rises above this iterate's
        self.w = self._solve(self.K, self.w)

    def build_trace(self, itrs: int) -> torch.Tensor:
        """(itrs, N) weights at budgets K+1..K+itrs."""
        ws = torch.empty((int(itrs), self.A.shape[1]), dtype=self.A.dtype, device=self.A.device)
        for i in range(int(itrs)):
            self.K = min(self.K + 1, self.max_support)
            self.w = ws[i] = self._solve(self.K, self.w)
        return ws
