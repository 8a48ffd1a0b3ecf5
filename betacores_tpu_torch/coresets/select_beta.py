"""Robust external selection of the density-power parameter beta
(counterpart of betacores_tpu/coresets/select_beta.py).

The in-build tangent objective cannot identify the beta that best matches
the clean posterior (its raw residual even has a degenerate minimum at
beta -> inf), so beta is chosen outside the build: build at each candidate,
score each build by the TRIMMED mean of per-point held-out predictive
log-likelihood (dropping the lowest ``trim`` fraction removes the unknown
contaminated held-out rows), and take the argmax. beta is state of the
build (``CoresetState.beta``), so one builder serves the whole grid.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["trimmed_mean", "select_beta", "padded_scorer", "driver_select_beta"]


def trimmed_mean(x, trim: float) -> torch.Tensor:
    """Mean of ``x`` after dropping its lowest ``trim`` fraction (one-sided:
    contamination shows as very negative scores). ``trim`` is clipped to
    [0, 0.5]."""
    x = torch.as_tensor(x).reshape(-1)
    k = int(np.floor(float(np.clip(trim, 0.0, 0.5)) * x.shape[0]))
    return torch.sort(x).values[k:].mean()


def select_beta(build_fn: Callable[[float], Tuple[np.ndarray, np.ndarray]],
                betas: Sequence[float], score_fn: Callable, trim: float = 0.2
                ) -> Tuple[float, np.ndarray]:
    """The beta whose coreset maximises the trimmed held-out predictive
    log-likelihood. ``build_fn(beta) -> (weights, points)`` builds a fresh
    coreset at beta; ``score_fn(weights, points) -> (n_val,)`` scores a
    held-out split under its posterior. Returns (best beta, scores). A
    build that scores NaN never wins; all NaN raises ValueError."""
    scores = []
    for b in betas:
        w, p = build_fn(float(b))
        scores.append(float(trimmed_mean(score_fn(w, p), trim)))
    scores = np.asarray(scores)
    ranked = np.where(np.isfinite(scores), scores, -np.inf)
    if not np.isfinite(ranked).any():
        raise ValueError(f"select_beta: every candidate build scored NaN/inf "
                         f"(scores={scores})")
    return float(betas[int(np.argmax(ranked))]), scores


def padded_scorer(M: int, D: int, pred_ll: Callable, dtype=np.float32,
                  device=None) -> Callable:
    """``score_fn(w, p)`` that zero-weight-pads every build to one (M, D)
    shape and calls ``pred_ll(wts, pts)`` on tensors on ``device`` (None:
    the card)."""
    from .api import resolve_device

    dev = resolve_device(device)

    def score_fn(wm, pm):
        wm, pm = np.atleast_1d(wm), np.atleast_2d(pm)
        wp = np.zeros(M, dtype=dtype)
        pp = np.zeros((M, D), dtype=dtype)
        wp[:len(wm)], pp[:len(wm)] = wm, pm
        return pred_ll(torch.from_numpy(wp).to(dev), torch.from_numpy(pp).to(dev))

    return score_fn


def driver_select_beta(alg_sel, grid: Sequence[float], score_fn: Callable,
                       trim: float, M_sel: int):
    """The example drivers' --select-beta block: the grid through
    ``select_beta`` on one eager ``BetaCoreset`` (reset and rebuilt at each
    beta), timed. Returns (best beta, record, cache) with cache[beta] =
    (wts, pts) of each candidate build."""
    cache = {}

    def build_fn(b):
        alg_sel._beta0 = b
        alg_sel.reset()
        alg_sel.build(M_sel, M_sel)
        wb, pb = alg_sel.get()[:2]
        cache[b] = (wb, pb)
        return wb, pb

    t0 = time.perf_counter()
    best_beta, scores = select_beta(build_fn, list(grid), score_fn, trim=trim)
    record = {"grid": [float(b) for b in grid], "scores": [float(s) for s in scores],
              "beta": best_beta, "trim": trim, "select_time_s": time.perf_counter() - t0}
    return best_beta, record, cache
