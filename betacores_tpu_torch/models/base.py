"""Model bundle interface (counterpart of betacores_tpu/models/base.py).

A model family is a ``ModelFns`` bundle of functions over

    pts     : (N, D) data points (for logistic regression z = y * x)
    thetas  : (S, d) posterior parameter samples
    beta    : beta-divergence robustness parameter (0-d tensor or float)

``log_likelihood(pts, thetas)[n, s]`` = log p(pts[n] | thetas[s]);
``beta_likelihood`` is the beta-divergence surrogate in the positive
convention (beta+1)/beta * p^beta - integral p^(beta+1); ``beta_gradient``
is its d/d(beta). Each family's bundle gives it in closed form, as plain
tensor code that a program can trace inside a loop; the forward-mode
derivative (``beta_gradient_from_autodiff``, the reference's ``jax.jvp``)
is its plain twin, which the tests hold every closed form against, and the
default for a model that brings only a ``beta_likelihood``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch


@functools.cache
def identity(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (d, d) identity, made once per size, dtype and device: the
    Newton refit needs it in every iteration (the prior's Hessian, the
    right-hand side of L^-1), and a fresh one each time is one more launch
    per use. Read-only: callers never write to it."""
    return torch.eye(d, dtype=dtype, device=device)


class Prior:
    """A sampler's fixed tensors (a prior's mean and scale), kept per dtype
    and device once made: a captured step then reads them at a fixed
    address and copies nothing from the host. ``dtype`` is the first
    tensor's."""

    def __init__(self, *tensors):
        self.tensors = tuple(torch.as_tensor(t) for t in tensors)
        self.dtype = self.tensors[0].dtype
        self._at: dict = {}

    def at(self, dtype: torch.dtype, device) -> tuple:
        key = (dtype, torch.device(device))
        got = self._at.get(key)
        if got is None:
            got = tuple(t.to(dtype=dtype, device=device) for t in self.tensors)
            # a traced program computes the cast itself and keeps no tensor
            # of the trace
            if not torch.compiler.is_compiling():
                self._at[key] = got
        return got


class ModelFns(NamedTuple):
    """Function bundle for one model family (the fields the port uses)."""

    # (N, D), (S, d) -> (N, S)
    log_likelihood: Callable
    # (N, D), (S, d), beta -> (N, S)
    beta_likelihood: Optional[Callable] = None
    # (N, D), (S, d), beta -> (N, S): d/d(beta) of beta_likelihood, in
    # closed form in every family's bundle
    beta_gradient: Optional[Callable] = None
    # (N, D), (S, d) -> (N, S, D): gradient w.r.t. the data row
    grad_z_log_likelihood: Optional[Callable] = None
    # single-launch refinement step of the incremental build's Adam loop:
    # (xin, z, mu, linv, w, m1, m2, sc, sclr, s_true) -> (w', m1', m2'),
    # see ops/kernels.py::logreg_adam_step
    fused_ll_grad_step: Optional[Callable] = None
    fused_beta_grad_step: Optional[Callable] = None
    # centred projection in one kernel, taken for row blocks of at least
    # ops/kernels.py::FUSED_MIN_ROWS (ops/projection.py):
    # (pts, th) -> (N, S) and (pts, th, beta) -> (N, S)
    fused_ll_projection: Optional[Callable] = None
    fused_beta_projection: Optional[Callable] = None
    # shard-local partials of one sharded refinement step in one kernel
    # (parallel/sharded.py): (xin, z, mu, linv, w, sc, s_true) ->
    # (colsum, core, corerow, wcore), see
    # ops/kernels.py::logreg_shard_step_partials
    fused_ll_shard_partials: Optional[Callable] = None
    fused_beta_shard_partials: Optional[Callable] = None


def as_beta(beta, pts: torch.Tensor) -> torch.Tensor:
    """``beta`` (a float or a 0-d tensor) as a tensor in the rows' dtype and
    on their device. A tensor already there is used as it is, so the call
    makes no host-to-device copy and can be captured in a CUDA graph."""
    return torch.as_tensor(beta, dtype=pts.dtype, device=pts.device)


def power_gradient(beta: torch.Tensor, ll: torch.Tensor) -> torch.Tensor:
    """d/d(beta) of (beta+1)/beta * exp(beta ll), the first term of every
    family's beta-likelihood: exp(beta ll) ((beta+1)/beta ll - 1/beta^2)."""
    return torch.exp(beta * ll) * ((beta + 1.0) / beta * ll - 1.0 / (beta * beta))


def beta_gradient_from_autodiff(beta_likelihood: Callable) -> Callable:
    """Exact d/d(beta) of a beta-likelihood by forward-mode autodiff: beta
    is one scalar and the output the whole (N, S) block, so one JVP gives
    the whole gradient. Pass the plain ``beta_likelihood``, never a kernel
    wrapper (a kernel has no forward-mode rule). The function returned is
    marked ``forward_mode = True``: ``torch.export`` does not trace a JVP
    inside a loop body, so an exported ``learn_beta`` build refuses it
    (utils/export.py::build_program) and needs the closed form instead."""

    def beta_gradient(pts, thetas, beta):
        beta = as_beta(beta, pts)
        _, tangent = torch.func.jvp(lambda b: beta_likelihood(pts, thetas, b),
                                    (beta,), (torch.ones_like(beta),))
        return tangent

    beta_gradient.forward_mode = True
    return beta_gradient
