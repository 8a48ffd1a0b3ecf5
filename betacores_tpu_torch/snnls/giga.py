"""GIGA: Greedy Iterative Geodesic Ascent (counterpart of
betacores_tpu/snnls/giga.py; Campbell & Broderick 2018).

On the unit sphere: the columns of A and the target b are normalised; an
iteration picks the column maximising the geodesic-alignment score
< An, cdir > / sqrt(1 - < An, xwn >^2), cdir the normalised part of bn
orthogonal to the iterate's direction xwn, then takes the closed-form
geodesic step and rescales onto b. The select is one (N, D) x (D, 2)
product over the whole column block and one first-maximum argmax.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils import errors
from .base import SparseNNLS


class GigaPre(NamedTuple):
    A: torch.Tensor       # (D, N)
    An: torch.Tensor      # (D, N) unit columns
    bn: torch.Tensor      # (D,) unit target
    bnorm: torch.Tensor   # 0-d


def giga_precompute(A: torch.Tensor, b: torch.Tensor) -> GigaPre:
    norms = torch.sqrt(torch.sum(A * A, dim=0))
    bnorm = torch.linalg.norm(b)
    return GigaPre(A=A, An=A / norms[None, :], bn=b / bnorm, bnorm=bnorm)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0.0, 1.0, x)


def geodesic_reweight(xw, nw, xwn, xf, wf_old, bn, bnorm):
    """The closed-form geodesic step, shared by the single-device step and
    the distributed one of parallel/hilbert.py (whose equality with it rests
    on both using this arithmetic). Returns (a, scale, new_wf, ok_geo): the
    weights rescale by ``a * scale`` and the selected column's weight
    becomes ``new_wf``. Degenerate input gives finite values and
    ok_geo false (the reference raises NumericalPrecisionError)."""
    nf = _nonzero(torch.linalg.norm(xf))
    xfn = xf / nf
    bn_f = bn @ xfn
    bn_w = bn @ xwn
    f_w = xwn @ xfn
    gA = bn_f - bn_w * f_w
    gB = bn_w - bn_f * f_w
    ok_geo = (gA > 0.0) & (gB >= 0.0)
    gsum = _nonzero(gA + gB)
    a = gB / gsum / nw
    bcoef = gA / gsum / nf
    x = a * xw + bcoef * xf
    nx = _nonzero(torch.linalg.norm(x))
    scale = bnorm / nx * ((x / nx) @ bn)
    new_wf = torch.clamp_min(wf_old * a * scale + bcoef * scale, 0.0)
    return a, scale, new_wf, ok_geo


def giga_scores(An_T: torch.Tensor, xw: torch.Tensor, bn: torch.Tensor, tol):
    """The select's half shared with the distributed step: (scores (N,),
    xwn, nw, ok_select) for unit rows ``An_T`` (N, D) and the iterate
    ``xw``."""
    nw = _nonzero(torch.linalg.norm(xw))
    xwn = xw / nw
    cdir = bn - (bn @ xwn) * xwn
    cnrm = torch.linalg.norm(cdir)
    ok_select = cnrm >= tol
    cdirn = cdir / _nonzero(cnrm)
    s = An_T @ torch.stack([cdirn, xwn], dim=1)        # (N, 2): one product
    num, dxw = s[:, 0], s[:, 1]
    stable = (dxw > -1.0 + 1e-14) & (1.0 - dxw * dxw > 0.0)
    denom = torch.where(stable, torch.sqrt(torch.clamp_min(1.0 - dxw * dxw, 0.0)),
                        torch.inf)
    return num / denom, xwn, nw, ok_select


def giga_step(pre: GigaPre, w: torch.Tensor, tol=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One select and reweight. Returns (w_new, ok); what the reference
    signals with NumericalPrecisionError is ok false. ``tol`` defaults to
    the current ``errors.TOL``."""
    if tol is None:
        tol = errors.TOL
    A, An, bn, bnorm = pre
    xw = A @ w
    scores, xwn, nw, ok_select = giga_scores(An.T, xw, bn, tol)
    f = torch.argmax(scores).view(1)
    a, scale, new_wf, ok_geo = geodesic_reweight(
        xw, nw, xwn, A.index_select(1, f)[:, 0], w.index_select(0, f)[0], bn, bnorm)
    w_new = (a * scale * w).scatter(0, f, new_wf.view(1))
    return w_new, ok_select & ok_geo


class GIGA(SparseNNLS):
    def _precompute(self) -> GigaPre:
        norms = torch.sqrt(torch.sum(self.A * self.A, dim=0))
        if bool((norms == 0).any()):
            raise ValueError("GIGA: A must not have any zero columns")
        if float(torch.linalg.norm(self.b)) == 0.0:
            raise errors.NumericalPrecisionError("GIGA: norm of b must be > 0")
        return giga_precompute(self.A, self.b)

    def _step_pre(self, pre, w, tol):
        return giga_step(pre, w, tol)
