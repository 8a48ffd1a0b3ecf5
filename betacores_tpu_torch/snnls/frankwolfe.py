"""Frank-Wolfe on the weighted simplex (counterpart of
betacores_tpu/snnls/frankwolfe.py; Campbell & Broderick 2017).

Selects argmax_n < An, b - Aw >; the first step puts the iterate on the
constraint polytope (w_f = sum_n ||A_n|| / ||A_f||), later ones take the
closed-form line search gamma = < (sigma/sigma_f) x_f - xw, b - xw > /
||(sigma/sigma_f) x_f - xw||^2 under the reference's precision guards.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .base import SparseNNLS


class FWPre(NamedTuple):
    A: torch.Tensor
    An: torch.Tensor
    norms: torch.Tensor
    b: torch.Tensor


def fw_precompute(A: torch.Tensor, b: torch.Tensor) -> FWPre:
    norms = torch.sqrt(torch.sum(A * A, dim=0))
    return FWPre(A=A, An=A / norms[None, :], norms=norms, b=b)


def fw_step(pre: FWPre, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    A, An, norms, b = pre
    xw = A @ w
    f = torch.argmax(An.T @ (b - xw)).view(1)
    nsum = torch.sum(norms)
    nf = norms.index_select(0, f)[0]
    xf = A.index_select(1, f)[:, 0]
    first = ~(w > 0).any()             # the first point's special case

    dirn = nsum / nf * xf - xw
    num = dirn @ (b - xw)
    den = torch.sum(dirn * dirn)
    ok_ls = (num >= 0.0) & (den > 0.0) & (num <= den)
    gamma = num / torch.where(den == 0.0, 1.0, den)

    alpha = torch.where(first, 0.0, 1.0 - gamma)
    beta = torch.where(first, nsum / nf, nsum / nf * gamma)
    wf = torch.clamp_min(alpha * w.index_select(0, f) + beta, 0.0)
    return (alpha * w).scatter(0, f, wf), first | ok_ls


class FrankWolfe(SparseNNLS):
    def _precompute(self) -> FWPre:
        norms = torch.sqrt(torch.sum(self.A * self.A, dim=0))
        if bool((norms == 0).any()):
            raise ValueError("FrankWolfe: A must not have any zero columns")
        return fw_precompute(self.A, self.b)

    def _step_pre(self, pre, w, tol):
        del tol  # FW's precision guard is scale-relative
        return fw_step(pre, w)
