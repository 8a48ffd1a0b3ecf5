"""Refits for the tests of the Newton loop's two forms (betacores_tpu_torch/
inference/laplace.py): the eager fixed-count loop and the captured loop of
conditional bodies. Shared by tests/test_torch_laplace.py (the CPU, with a
host stand-in for the conditional node) and tests/test_torch_laplace_cuda.py
(the card). It imports no JAX.

A case is a target (log joint, gradient, Hessian) over data in fixed
tensors, a budget, and a start written into a fixed ``mu0`` buffer, so that
one captured refit can be replayed from another start:

- ``cold``: zeros under a budget of three iterations, every one of them
  entered undone (the loop ends at its budget);
- ``warm``: the mode of a full fit, converged at entry (no iteration);
- ``near``: a tenth of the way from the mode to zeros: two iterations
  (logistic, multiclass) to five (Poisson's Fisher scoring, in float64),
  fewer than the budget;
- ``indefinite``: -H = [[1, 2], [2, 1]], not positive definite: the
  reference's NaN factor, every candidate scores -inf, one iteration;
- ``no_improvement``: a gradient that points away from the maximum the
  start already holds: no candidate improves, the ``~improved`` exit after
  one iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from betacores_tpu_torch.inference import (logreg_laplace_sampler,
                                           multiclass_laplace_sampler,
                                           poisson_laplace_sampler)
from betacores_tpu_torch.inference.laplace import newton_laplace
from betacores_tpu_torch.utils import profiling

FAMILIES = ("logreg", "logreg_inv", "multiclass", "poisson")
STARTS = ("cold", "warm", "near")
# (case, start) pairs of the tests: every family from every start, and the
# exits that do not depend on the start
CASES = [(f, s) for f in FAMILIES for s in STARTS] + [
    ("indefinite", "fixed"), ("indefinite_inv", "fixed"), ("no_improvement", "fixed")]
COLD_BUDGET = 3


class Refit(NamedTuple):
    target: tuple           # (log_joint, grad, hess) over fixed tensors
    mu0: torch.Tensor       # the start's buffer
    n_iters: int
    with_inverse: bool

    def fit(self):
        return newton_laplace(*self.target, self.mu0, n_iters=self.n_iters,
                              with_inverse=self.with_inverse)


def _data(family: str, device, dtype, seed: int = 11):
    """(wts, pts, sampler, dimension of theta) of a small problem."""
    rng = np.random.default_rng(seed)
    d = 10
    if family.startswith("logreg"):
        n, th = 200, rng.normal(size=d)
        X = rng.normal(size=(n, d))
        y = np.where(X @ th + rng.normal(size=n) > 0, 1.0, -1.0)
        pts, smp, dim = y[:, None] * X, logreg_laplace_sampler(), d
    elif family == "multiclass":
        n, K = 300, 5
        X = rng.normal(size=(n, d))
        y = np.argmax(X @ rng.normal(size=(d, K)) + rng.gumbel(size=(n, K)), axis=1)
        pts = np.concatenate([X, y[:, None]], axis=1)
        smp, dim = multiclass_laplace_sampler(K), K * d
    else:
        n = 200
        X = rng.normal(size=(n, d)) / np.sqrt(d)
        y = rng.poisson(np.log1p(np.exp(X @ rng.normal(size=d) + 1.0)))
        pts, smp, dim = np.concatenate([X, y[:, None]], axis=1), poisson_laplace_sampler(), d
    wts = rng.uniform(0.5, 2.0, size=n)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return as_t(wts), as_t(pts), smp, dim


def _special(case: str, device, dtype) -> Refit:
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    if case.startswith("indefinite"):
        A, b = t([[1.0, 2.0], [2.0, 1.0]]), t([0.3, -0.2])
        target = (lambda th: -0.5 * ((th @ A) * th).sum(-1) + th @ b,
                  lambda th: b - A @ th, lambda th: -A)
        return Refit(target, t([0.5, 0.25]), 8, case == "indefinite_inv")
    g, eye = t([1.0, 0.0]), t([[1.0, 0.0], [0.0, 1.0]])
    target = (lambda th: -(th * th).sum(-1), lambda th: g, lambda th: -eye)
    return Refit(target, t([0.0, 0.0]), 8, False)


def family_refit(family: str, device, dtype=torch.float64) -> tuple:
    """(Refit of ``family`` under its sampler's budget from zeros, the mode
    of that fit)."""
    wts, pts, smp, dim = _data(family, device, dtype)
    refit = Refit(smp._target(wts, pts), torch.zeros(dim, dtype=dtype, device=device),
                  smp.n_newton, family == "logreg_inv")
    return refit, refit.fit().mu.clone()


def start(mode: torch.Tensor, name: str) -> torch.Tensor:
    """The start ``name`` (module docstring) of a family with this mode."""
    return {"cold": torch.zeros_like(mode), "warm": mode, "near": 0.9 * mode}[name]


def case_refit(case: str, start_name: str, device, dtype=torch.float64) -> Refit:
    """The refit of one (case, start) of ``CASES``, its start in ``mu0``."""
    if start_name == "fixed":
        return _special(case, device, dtype)
    refit, mode = family_refit(case, device, dtype)
    refit.mu0.copy_(start(mode, start_name))
    return refit._replace(n_iters=COLD_BUDGET) if start_name == "cold" else refit


def expect(start_name: str, needed: int, n_iters: int) -> None:
    """Asserts that a fit from ``start_name`` entered as many iterations
    undone as the start is for (module docstring)."""
    if start_name == "cold":
        assert needed == n_iters
    elif start_name == "warm":
        assert needed == 0
    elif start_name == "near":
        assert 2 <= needed < n_iters
    else:
        assert needed == 1


def counts() -> tuple:
    """(iterations entered undone, iterations executed) the recorder
    counted since its last reset, under no span."""
    c = profiling.snapshot().counters
    return (c.get(("newton.iters_needed", None), 0),
            c.get(("newton.iters_executed", None), 0))


def same(a, b) -> bool:
    """Whether two fits are equal bit for bit (NaN where NaN)."""
    pairs = [(a.mu, b.mu), (a.prec_chol, b.prec_chol)]
    if a.prec_chol_inv is not None or b.prec_chol_inv is not None:
        pairs.append((a.prec_chol_inv, b.prec_chol_inv))
    return all(torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())
               for x, y in pairs)
