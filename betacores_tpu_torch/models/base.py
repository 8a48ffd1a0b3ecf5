"""Model bundle interface (counterpart of betacores_tpu/models/base.py).

A model family is a ``ModelFns`` bundle of functions over

    pts     : (N, D) data points (for logistic regression z = y * x)
    thetas  : (S, d) posterior parameter samples
    beta    : beta-divergence robustness parameter (0-d tensor or float)

``log_likelihood(pts, thetas)[n, s]`` = log p(pts[n] | thetas[s]);
``beta_likelihood`` is the beta-divergence surrogate in the positive
convention (beta+1)/beta * p^beta - integral p^(beta+1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional


class ModelFns(NamedTuple):
    """Function bundle for one model family (the fields the port uses)."""

    # (N, D), (S, d) -> (N, S)
    log_likelihood: Callable
    # (N, D), (S, d), beta -> (N, S)
    beta_likelihood: Optional[Callable] = None
    # single-launch refinement step of the incremental build's Adam loop:
    # (xin, z, mu, linv, w, m1, m2, sc, sclr, s_true) -> (w', m1', m2'),
    # see ops/kernels.py::logreg_adam_step
    fused_ll_grad_step: Optional[Callable] = None
    fused_beta_grad_step: Optional[Callable] = None
