"""The plain reference of one β-Cores selection: select, then the refinement
pass, written in plain PyTorch from the method's definition (Manousakas &
Mascolo, WSDM 2021, arXiv:2008.13600) and the port's documented choices.

It imports nothing of the program under test and takes nothing the program
made: it gets the benchmark's data and draws, a state to start from, and a
model family (``families/<name>.py``: the weighted log joint, its gradient
and Hessian, and the uncentred β-likelihood). It runs in any dtype; the
benchmark runs it in float64 to judge the program, and in float32 with TF32
products as the control (``compare.py``).

One selection from a state (wts, idcs, pts, m, beta, aux[, selected]):

- select: the Laplace fit of the coreset at its weights, warm-started at
  ``aux``, by damped Newton (a fixed number of iterations that stop once
  the Newton decrement is below tolerance, an 8-point backtracking grid,
  a step that does not improve ends the fit); S samples mu + L^-T z from
  the handed noise; the centred β-likelihood projections of the candidate
  rows (a subsample, every row, or every group's rows summed) and of the
  buffer; the candidate that best correlates with the residual
  scaling * sum v - w . corevecs is installed when it beats every buffer
  point, is not in the buffer yet and fits.
- refinement: T projected-Adam steps; each refits the posterior at the
  current weights (warm-started at the last fit), draws its samples from
  the step's noise and takes the gradient -(corevecs . resid) / S over the
  step's subsample rows (scaled by N / n) or over every row.

Only live buffer slots are computed: padding slots have zero weight and a
zero projection, so they add nothing to any sum and keep their zero weight.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LINE_SEARCH = tuple(0.5 ** k for k in range(8))
# a select over every row holds its candidates' (N, S) projections whole up
# to this many bytes; beyond it, it makes them twice, block by block (their
# sum, then each row's score)
WHOLE_BYTES = 8 << 30
# the Newton stopping tolerance of the configuration's dtype (the decrement
# g . (-H)^-1 g against tol * (1 + |log joint|))
NEWTON_TOL = {"float32": 1e-5, "float64": 1e-7}


class RefState(NamedTuple):
    """A coreset state as plain tensors: ``selected`` is None for a point
    build."""

    wts: torch.Tensor
    idcs: torch.Tensor
    pts: torch.Tensor
    m: int
    beta: float
    aux: torch.Tensor
    selected: Optional[torch.Tensor] = None


def as_ref_state(st, dtype=None) -> RefState:
    """A state of the program (a point or a group state, read by its field
    names) or a RefState, as a RefState on the same device."""
    core = getattr(st, "core", st)
    selected = getattr(st, "selected", None)
    aux = core.aux if isinstance(core, RefState) else core.sampler_aux
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    return RefState(wts=cast(core.wts.detach()), idcs=core.idcs.detach().to(torch.int64),
                    pts=cast(core.pts.detach()), m=int(core.m), beta=float(core.beta),
                    aux=cast(aux.detach()),
                    selected=None if selected is None else selected.detach().clone())


class SelectOutcome(NamedTuple):
    """What the reference's select decided: candidate ids (rows or groups),
    their scores, the best one, whether it was installed, and the largest
    score of a buffer point it had to beat (-inf when it had none)."""

    cand: torch.Tensor
    scores: torch.Tensor
    best: int
    add: bool
    take_new: bool
    hinges_on_score: bool
    core_max: float
    state: RefState


def center(v: torch.Tensor) -> torch.Tensor:
    return v - v.mean(dim=1, keepdim=True)


class Laplace(NamedTuple):
    mu: torch.Tensor
    chol: torch.Tensor


def newton_fit(fam, wts, pts, mu0, n_iters: int, tol: float) -> Laplace:
    """The mode of the weighted log joint and the Cholesky factor L of -H
    there. A factorisation that fails gives a NaN factor, so the step is
    rejected and the fit ends, as the method's Newton loop does."""
    d = mu0.shape[0]

    def eval_at(mu):
        g = fam.grad(pts, mu, wts)
        L, info = torch.linalg.cholesky_ex(-fam.hess(pts, mu, wts))
        if int(info) != 0:
            L = torch.full((d, d), float("nan"), dtype=mu.dtype, device=mu.device).tril()
        y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
        p = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        return L, p, float(g @ p)

    ts = torch.tensor(LINE_SEARCH, dtype=mu0.dtype, device=mu0.device)
    mu = mu0
    f = float(fam.log_joint(pts, mu, wts))
    L, p, lam2 = eval_at(mu)
    for _ in range(n_iters):
        if lam2 <= tol * (1.0 + abs(f)):
            break
        cands = mu[None, :] + ts[:, None] * p[None, :]
        vals = fam.log_joint(pts, cands, wts)
        vals = torch.where(torch.isfinite(vals), vals, float("-inf"))
        best = int(torch.argmax(vals))
        if not float(vals[best]) > f:
            break
        mu, f = cands[best], float(vals[best])
        L, p, lam2 = eval_at(mu)
    return Laplace(mu, L)


def samples_from(lap: Laplace, z: torch.Tensor) -> torch.Tensor:
    """(S, d) theta = mu + L^-T z for the (S, d) standard normals z."""
    return lap.mu + torch.linalg.solve_triangular(lap.chol.T, z.T, upper=True).T


def adam_corrections(n_steps: int, dtype, device) -> torch.Tensor:
    """(T, 2) [1 - b1^t, 1 - b2^t], t = 1..T."""
    t = torch.arange(1, n_steps + 1, dtype=torch.float64)
    bc = torch.stack([1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t], dim=1)
    return bc.to(dtype=dtype, device=device)


class Reference:
    """One family's selections over one dataset: ``select(st, z, idx)`` and
    ``refine(st, z_all, idx_all)`` on plain states. ``groups`` (G, rows per
    group) makes select score contiguous blocks of rows; ``block`` bounds the
    rows projected at once."""

    def __init__(self, fam, data, config: dict, dtype=torch.float64, groups=None,
                 block: int = 1 << 17):
        self.fam, self.dtype = fam, dtype
        # whole groups to a block, so that each group sums inside one
        self.block = block if groups is None else groups[1] * max(1, block // groups[1])
        self.data = data.to(dtype)
        self.S = int(config["projection_dim"])
        self.n_newton = int(config["n_newton"])
        self.tol = NEWTON_TOL[config["dtype"]]
        self.i0 = float(config["i0"])
        self.groups = groups

    # --- pieces -------------------------------------------------------------

    def fit(self, st: RefState, wts) -> Laplace:
        m = st.m
        return newton_fit(self.fam, wts[:m], st.pts[:m], st.aux, self.n_newton, self.tol)

    def project(self, rows, th, beta) -> torch.Tensor:
        """Centred (n, S) β-likelihood projections, in row blocks."""
        if rows.shape[0] == 0:
            return rows.new_zeros((0, self.S))
        return torch.cat([center(self.fam.beta_likelihood(rows[i:i + self.block], th, beta))
                          for i in range(0, rows.shape[0], self.block)])

    def project_sum(self, th, beta) -> torch.Tensor:
        """(S,) the sum of every row's centred projection, by row blocks."""
        out = torch.zeros(self.S, dtype=self.dtype, device=self.data.device)
        for i in range(0, self.data.shape[0], self.block):
            out += center(self.fam.beta_likelihood(self.data[i:i + self.block], th, beta)).sum(0)
        return out

    def group_sums(self, th, beta) -> torch.Tensor:
        """(G, S) each group's sum of its rows' centred projections (groups
        are contiguous blocks of rows)."""
        per = self.groups[1]
        return torch.cat([
            center(self.fam.beta_likelihood(self.data[i:i + self.block], th, beta))
            .reshape(-1, per, self.S).sum(1)
            for i in range(0, self.data.shape[0], self.block)])

    def cast(self, st: RefState) -> RefState:
        return st._replace(wts=st.wts.to(self.dtype), pts=st.pts.to(self.dtype),
                           aux=st.aux.to(self.dtype))

    # --- select -------------------------------------------------------------

    def select(self, st: RefState, z, idx) -> SelectOutcome:
        """Select from ``st`` with the noise ``z`` (S, d) and the candidate
        draw ``idx`` (rows or groups; None: every row or group)."""
        st, z = self.cast(st), z.to(self.dtype)
        lap = self.fit(st, st.wts)
        th = samples_from(lap, z)
        m, M_max, S = st.m, st.wts.shape[0], self.S
        core = self.project(st.pts[:m], th, st.beta)
        w = st.wts[:m]
        vecs = None
        if self.groups is not None:
            G, per = self.groups
            gvecs = self.group_sums(th, st.beta)
            cand = torch.arange(G, device=gvecs.device) if idx is None else idx
            vecs = gvecs if idx is None else gvecs[idx]
            scaling = 1.0 if idx is None else G / idx.shape[0]
        elif idx is None and self.data.shape[0] * S * self.data.element_size() > WHOLE_BYTES:
            cand = torch.arange(self.data.shape[0], device=self.data.device)
            resid = self.project_sum(th, st.beta) - w @ core
            scores = torch.cat([self._scores(center(self.fam.beta_likelihood(
                self.data[i:i + self.block], th, st.beta)), resid)
                for i in range(0, self.data.shape[0], self.block)])
        elif idx is None:
            cand = torch.arange(self.data.shape[0], device=self.data.device)
            vecs, scaling = self.project(self.data, th, st.beta), 1.0
        else:
            cand = idx
            vecs = self.project(self.data[idx], th, st.beta)
            scaling = self.data.shape[0] / idx.shape[0]
        if vecs is not None:
            resid = scaling * vecs.sum(0) - w @ core
            scores = self._scores(vecs, resid)
        size = 1 if self.groups is None else self.groups[1]
        if self.groups is not None:
            # groups that do not fit the remaining room never win
            scores = torch.where(torch.full_like(scores, m + size) <= M_max, scores, -torch.inf)
        b = int(torch.argmax(scores))
        f, c_best = int(cand[b]), float(scores[b])
        cn = torch.sqrt((core * core).sum(1))
        core_scores = torch.abs(core @ resid) / torch.where(cn > 0, cn, torch.inf) / S
        core_max = float(core_scores.max()) if m > 0 else float("-inf")
        take_new = m == 0 or c_best > core_max
        if self.groups is None:
            fits = m < M_max
            already = bool((st.idcs[:m] == f).any())
        else:
            fits = m + size <= M_max
            already = bool(st.selected[f])
        add = take_new and fits and not already
        new = self._install(st, f, size) if add else st
        new = new._replace(aux=lap.mu)
        return SelectOutcome(cand, scores, f, add, take_new, fits and not already and m > 0,
                             core_max, new)

    def _scores(self, vecs, resid) -> torch.Tensor:
        """Each candidate's correlation with the residual."""
        vn = torch.sqrt((vecs * vecs).sum(1))
        return (vecs @ resid) / torch.where(vn > 0, vn, torch.inf) / self.S

    def _install(self, st: RefState, f: int, size: int) -> RefState:
        m = st.m
        rows = torch.arange(f * size, (f + 1) * size, device=st.idcs.device)
        wts, idcs, pts = st.wts.clone(), st.idcs.clone(), st.pts.clone()
        wts[m:m + size] = 0.0
        idcs[m:m + size] = rows
        pts[m:m + size] = self.data[rows]
        selected = None
        if st.selected is not None:
            selected = st.selected.clone()
            selected[f] = True
        return st._replace(wts=wts, idcs=idcs, pts=pts, m=m + size, selected=selected)

    # --- refinement -----------------------------------------------------------

    def refine(self, st: RefState, z_all, idx_all) -> RefState:
        """The refinement pass from ``st`` with the (T, S, d) noise and the
        (T, n) subsample rows (None: every row, scaling 1)."""
        st = self.cast(st)
        T, S, m = z_all.shape[0], self.S, st.m
        dt, dev = self.dtype, st.wts.device
        lr = self.i0 / (1.0 + torch.arange(T, dtype=dt, device=dev))
        bc = adam_corrections(T, dt, dev)
        x = st.wts[:m].clone()
        m1, m2 = torch.zeros_like(x), torch.zeros_like(x)
        pts, aux = st.pts[:m], st.aux
        N = self.data.shape[0]
        for i in range(T):
            lap = newton_fit(self.fam, x, pts, aux, self.n_newton, self.tol)
            aux = lap.mu
            th = samples_from(lap, z_all[i].to(dt))
            core = self.project(pts, th, st.beta)
            if idx_all is None:
                target = self.project_sum(th, st.beta)
            else:
                target = (N / idx_all.shape[1]) * self.project(self.data[idx_all[i]], th,
                                                                st.beta).sum(0)
            g = -(core @ (target - x @ core)) / S
            m1 = ADAM_B1 * m1 + (1.0 - ADAM_B1) * g
            m2 = ADAM_B2 * m2 + (1.0 - ADAM_B2) * g * g
            x = torch.clamp_min(
                x - lr[i] * (m1 / bc[i, 0]) / (ADAM_EPS + torch.sqrt(m2 / bc[i, 1])), 0.0)
        wts = st.wts.clone()
        wts[:m] = x
        return st._replace(wts=wts, aux=aux)


def log_prior(th: torch.Tensor) -> torch.Tensor:
    """Standard normal prior over the last axis."""
    return -0.5 * th.shape[-1] * math.log(2.0 * math.pi) - 0.5 * (th * th).sum(-1)
