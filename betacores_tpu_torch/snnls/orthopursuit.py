"""Orthogonal matching pursuit with a full NNLS re-solve (counterpart of
betacores_tpu/snnls/orthopursuit.py).

Select searches the positive residual correlation over all columns and the
negative one over the active set (so a weight may fall); the reweight
re-solves NNLS on the active support with the FISTA solver of
snnls/nnls.py in place of the reference's scipy.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .base import SparseNNLS
from .nnls import nnls_on_support


class OMPPre(NamedTuple):
    A: torch.Tensor
    An: torch.Tensor
    b: torch.Tensor


def omp_step(pre: OMPPre, w: torch.Tensor, max_support: int,
             nnls_iters: int = 400) -> Tuple[torch.Tensor, torch.Tensor]:
    A, An, b = pre
    dots = An.T @ (b - A @ w)
    active = w > 0
    fpos = torch.argmax(dots)
    neg_scores = torch.where(active, -dots, -torch.inf)
    fneg = torch.argmax(neg_scores)
    take_pos = ~active.any() | (dots[fpos.view(1)] >= neg_scores[fneg.view(1)])[0]
    f = torch.where(take_pos, fpos, fneg).view(1)
    support = active.scatter(0, f, True)
    w_new = nnls_on_support(A, b, support, max_support, n_iters=nnls_iters)
    return w_new, torch.ones((), dtype=torch.bool, device=w.device)


class OrthoPursuit(SparseNNLS):
    def _precompute(self) -> OMPPre:
        norms = torch.sqrt(torch.sum(self.A * self.A, dim=0))
        if bool((norms == 0).any()):
            raise ValueError("OrthoPursuit: A must not have any zero columns")
        return OMPPre(A=self.A, An=self.A / norms[None, :], b=self.b)

    def _step_pre(self, pre, w, tol):
        del tol  # OMP's guards are geometric, not tolerance-based
        return omp_step(pre, w, self.max_support)
