"""Sparse non-negative least squares: the shared build driver and the
eager solver API (counterpart of betacores_tpu/snnls/base.py).

Solves min_w ||A w - b||, w >= 0, growing the support greedily one column
an iteration. A solver gives a step ``step(w) -> (w_new, ok)`` (the
reference's select and reweight); :func:`build` adds the reference's
failure contract: an iteration that fails (``ok`` false, or the error rose)
reverts the weights, the next one retries, and a second failure in a row
latches ``reached_numeric_limit``, after which nothing moves. The branches
are ``torch.where`` over every field and the loop reads nothing on the
host, so a build runs as a stream of device work; the latch is read once,
after the loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..utils import errors
from ..utils.device import resolve_device
from ..utils.logging import get_logger
from .nnls import nnls_on_support


class BuildState(NamedTuple):
    w: torch.Tensor
    retried: torch.Tensor  # 0-d bool: the last iteration failed once already
    latched: torch.Tensor  # 0-d bool: reached_numeric_limit


StepFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _iterate(st: BuildState, step_fn: StepFn, error_fn: Callable,
             check_monotone: bool) -> BuildState:
    """One guarded greedy iteration; a latched state is left as it is."""
    w_new, ok = step_fn(st.w)
    fail = ~ok
    if check_monotone:
        had_support = (st.w > 0).any()
        fail = fail | (had_support & (error_fn(w_new) > error_fn(st.w)))
    active = BuildState(w=torch.where(fail, st.w, w_new),
                        retried=fail & ~st.retried,
                        latched=st.latched | (fail & st.retried))
    return BuildState(*(torch.where(st.latched, old, new) for old, new in zip(st, active)))


def _start(w0: torch.Tensor) -> BuildState:
    flag = torch.zeros((), dtype=torch.bool, device=w0.device)
    return BuildState(w=w0, retried=flag, latched=flag)


def build(step_fn: StepFn, error_fn: Callable, w0: torch.Tensor, itrs: int,
          check_monotone: bool = True) -> BuildState:
    """``itrs`` guarded iterations from ``w0``. A failed iteration uses up
    its slot, as the reference's try/except inside ``for i in range(itrs)``
    does."""
    st = _start(w0)
    for _ in range(int(itrs)):
        st = _iterate(st, step_fn, error_fn, check_monotone)
    return st


def build_trace(step_fn: StepFn, error_fn: Callable, w0: torch.Tensor, itrs: int,
                check_monotone: bool = True) -> Tuple[torch.Tensor, BuildState]:
    """:func:`build` that also records the weights after every iteration:
    ((itrs, N) weights, final state); row m - 1 is the weights after m
    iterations."""
    st = _start(w0)
    ws = torch.empty((int(itrs), w0.shape[0]), dtype=w0.dtype, device=w0.device)
    for i in range(int(itrs)):
        st = _iterate(st, step_fn, error_fn, check_monotone)
        ws[i] = st.w
    return ws, st


def optimize(A: torch.Tensor, b: torch.Tensor, w: torch.Tensor, max_support: int,
             n_iters: int = 400, tol=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-solve the weights exactly on the current support, rolled back
    when the error rises by more than ``tol`` relative (default: the
    current ``errors.TOL``). Returns (w, rolled_back)."""
    if tol is None:
        tol = errors.TOL
    prev_err = torch.linalg.norm(A @ w - b)
    w_new = nnls_on_support(A, b, w > 0, max_support, n_iters=n_iters)
    ok = torch.linalg.norm(A @ w_new - b) <= prev_err * (1.0 + tol)
    return torch.where(ok, w_new, w), ~ok


def as_problem(A, b, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, b) as floating tensors on one device: a tensor ``A`` keeps its
    device, anything else goes to ``device`` (None: the card). Input that is
    not a real numeric (D, N) matrix and (D,) vector raises ValueError."""
    def tensor(x):
        if isinstance(x, torch.Tensor):
            t = x
        else:
            try:
                a = np.asarray(x)
            except (TypeError, ValueError) as e:
                raise ValueError(f"A, b must be numeric arrays: {e}") from None
            if a.dtype.kind not in "fiu":
                raise ValueError(f"A, b must be numeric, got dtype {a.dtype}")
            t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.bool or t.is_complex():
            raise ValueError(f"A, b must be real numbers, got dtype {t.dtype}")
        return t if t.is_floating_point() else t.to(torch.get_default_dtype())

    dev = A.device if isinstance(A, torch.Tensor) else resolve_device(device)
    A, b = tensor(A), tensor(b)
    if A.ndim != 2 or b.ndim != 1 or A.shape[0] != b.shape[0]:
        raise ValueError("A must be (D, N) and b (D,)")
    dtype = torch.promote_types(A.dtype, b.dtype)
    return A.to(dtype=dtype, device=dev), b.to(dtype=dtype, device=dev)


class SparseNNLS:
    """The reference's solver interface: ``build(itrs)``, ``build_trace``,
    ``optimize()``, ``weights()``, ``error()``, ``size()``, ``reset()``,
    ``reached_numeric_limit``. A subclass gives ``_precompute`` and
    ``_step_pre(pre, w, tol)``. The tolerance is ``errors.TOL`` as it
    stands at each call, so ``set_tolerance()`` acts between builds."""

    check_error_monotone = True

    def __init__(self, A, b, max_support: int | None = None, device=None):
        self.A, self.b = as_problem(A, b, device)
        self.max_support = int(max_support) if max_support is not None else min(self.A.shape)
        self.log = get_logger(self.__class__.__name__)
        self._pre = self._precompute()
        self.reset()

    # --- subclass hooks ---
    def _precompute(self):
        return None

    def _step_pre(self, pre, w, tol):
        """One select and reweight from the precomputed ``pre``; ``tol``
        is the numeric tolerance (solvers that need none ignore it)."""
        raise NotImplementedError

    # --- shared ---
    def _error(self, w):
        return torch.linalg.norm(self.A @ w - self.b)

    def _step_fn(self) -> StepFn:
        tol = errors.TOL
        return lambda w: self._step_pre(self._pre, w, tol)

    def reset(self) -> None:
        self.w = torch.zeros(self.A.shape[1], dtype=self.A.dtype, device=self.A.device)
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((self.w > 0).sum())

    def weights(self) -> np.ndarray:
        return self.w.cpu().numpy().copy()

    def error(self) -> float:
        return float(self._error(self.w))

    def _finish(self, st: BuildState) -> None:
        self.w = st.w
        if bool(st.latched):
            self.reached_numeric_limit = True
            self.log.warning("numeric limit reached: size=%d error=%g", self.size(),
                             self.error())

    def build(self, itrs: int) -> None:
        if self.reached_numeric_limit:
            self.log.warning("numeric limit already reached; returning")
            return
        if self.A.numel() == 0:
            self.log.warning("no data; returning")
            return
        self._finish(build(self._step_fn(), self._error, self.w, int(itrs),
                           self.check_error_monotone))

    def build_trace(self, itrs: int) -> torch.Tensor:
        """``itrs`` iterations, returning the (itrs, N) weights after each
        on the solver's device: row m - 1 equals the weights after ``build``
        of m iterations in all. Advances the solver to the last one."""
        ws, st = build_trace(self._step_fn(), self._error, self.w, int(itrs),
                             self.check_error_monotone)
        self._finish(st)
        return ws

    def optimize(self) -> None:
        self.w, rolled_back = optimize(self.A, self.b, self.w, self.max_support)
        if bool(rolled_back):
            self.reached_numeric_limit = True
            self.log.warning("optimize() increased cost; rolled back and latched")
