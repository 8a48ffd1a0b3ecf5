"""Least-angle-regression sparse NNLS, a homotopy on the weight path
(counterpart of betacores_tpu/snnls/lar.py, which made the reference's dead
solver work).

An iteration, from weights w with active set {w > 0}:
  1. solve NNLS on the active set -> w_opt;
  2. move along w(g) = (1 - g) w + g w_opt to the first event g in (0, 1]:
       - ENTER: an inactive column a_n becomes as aligned with the moving
         residual as the step direction s,
            g_n = (a_n - s).(b - A w) / (a_n - s).(A w_opt - A w);
       - LEAVE: an active weight crosses zero, g_n = w_n / (w_n - w_opt_n)
         for w_opt_n < 0 (cannot fire after a non-negative solve; kept for
         the contract);
  3. step to w(g*) and toggle the event's column; with no event before
     g = 1, jump to w_opt, where the path has converged.

Every shape is fixed: the active set is the w > 0 mask, the events are
masked argmins over all N columns and the restricted solve is the
fixed-width FISTA of snnls/nnls.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .base import SparseNNLS
from .nnls import nnls_on_support


class LARPre(NamedTuple):
    A: torch.Tensor
    An: torch.Tensor   # unit columns
    b: torch.Tensor


def lar_step(pre: LARPre, w: torch.Tensor, max_support: int,
             nnls_iters: int = 400) -> Tuple[torch.Tensor, torch.Tensor]:
    A, An, b = pre
    eps = 1e-12
    active = w > 0
    # cold start: activate the column most aligned with the residual
    f0 = torch.argmax(An.T @ (b - A @ w)).view(1)
    active = torch.where(active.any(), active, active.scatter(0, f0, True))

    w_opt = nnls_on_support(A, b, active, max_support, n_iters=nnls_iters)
    xw = A @ w
    dx = A @ w_opt - xw
    s = dx / torch.clamp_min(torch.sqrt(torch.sum(dx * dx)), eps)   # step direction

    # ENTER events over inactive columns; none once the support fills the
    # restricted solve's width
    num = (An - s[:, None]).T @ (b - xw)               # (N,)
    den = (An - s[:, None]).T @ dx
    bad = (den.abs() <= eps) | (num * den < 0)
    blocked = bad | active | (active.sum() >= max_support)
    g_enter = torch.where(blocked, torch.inf, num / torch.where(bad, 1.0, den))
    g_enter = torch.where(g_enter <= eps, torch.inf, g_enter)  # no zero-length steps
    f_enter = torch.argmin(g_enter).view(1)

    # LEAVE events over active columns
    leave = active & (w_opt < 0)
    g_leave = torch.where(leave, w / torch.where(leave, w - w_opt, 1.0), torch.inf)
    f_leave = torch.argmin(g_leave).view(1)

    ge, gl = g_enter.index_select(0, f_enter)[0], g_leave.index_select(0, f_leave)[0]
    g = torch.clamp_max(torch.minimum(ge, gl), 1.0)
    converged = (ge >= 1.0) & (gl >= 1.0)

    w_new = (1.0 - g) * w + g * w_opt
    # toggle the event column: the active set is the w > 0 mask, so an
    # entrant is seeded with a tiny positive weight for the next solve
    seed = torch.clamp_min(torch.max(w_new), 1.0) * 1e-7
    entered = torch.maximum(w_new.index_select(0, f_enter), seed.view(1))
    stepped = torch.where(gl < ge, w_new.scatter(0, f_leave, 0.0),
                          w_new.scatter(0, f_enter, entered))
    # prune faded columns: one the non-negative solve zeroes only decays
    # along the path and never crosses zero
    idx = torch.arange(w.shape[0], device=w.device)
    is_entrant = idx == torch.where(gl < ge, -1, f_enter[0])
    faded = (w_opt == 0.0) & (stepped <= 2.0 * seed)
    stepped = torch.where(faded & ~is_entrant, 0.0, stepped)
    w_new = torch.clamp_min(torch.where(converged, w_opt, stepped), 0.0)
    # at the restricted optimum with no event left the path has ended:
    # fail, so the build's retry and latch stop it. The tolerance follows
    # the dtype: the FISTA re-solve reproduces w_opt only to about
    # sqrt(machine eps) relative
    lat_tol = math.sqrt(torch.finfo(w.dtype).eps)
    already_opt = converged & (torch.max((w - w_opt).abs())
                               <= lat_tol * (1.0 + torch.max(w_opt)))
    return w_new, torch.isfinite(torch.sum(w_new)) & ~already_opt


class LAR(SparseNNLS):
    # a homotopy passes through event points whose residual may exceed the
    # previous iterate's before the path bends
    check_error_monotone = False

    def _precompute(self) -> LARPre:
        norms = torch.sqrt(torch.sum(self.A * self.A, dim=0))
        if bool((norms == 0).any()):
            raise ValueError("LAR: A must not have any zero columns")
        if float(torch.linalg.norm(self.b)) == 0.0:
            raise ValueError("LAR: norm of b must be > 0")
        return LARPre(A=self.A, An=self.A / norms, b=self.b)

    def _step_pre(self, pre, w, tol):
        del tol
        return lar_step(pre, w, self.max_support)
