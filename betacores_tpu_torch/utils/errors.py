"""Numerical-robustness contract (counterpart of betacores_tpu/utils/errors.py).

``NumericalPrecisionError`` is what the eager object API raises when a
refinement materially worsens the coreset; ``TOL`` is the mutable global
tolerance of its rollback guard (the reference's ``util.TOL``, adjustable
with ``set_tolerance``). The port's own copy: this package never imports the
JAX package.
"""

from __future__ import annotations

TOL = 1e-12


def set_tolerance(tol: float) -> None:
    global TOL
    TOL = tol


def get_tolerance() -> float:
    return TOL


class NumericalPrecisionError(Exception):
    """Raised when a numeric-precision limit is reached."""


# Status codes of the reference's solver state (its jitted solvers carry
# them where an exception cannot cross traced code); the same values here.
STATUS_OK = 0
# one step failed; the solver stabilised and will retry (transient)
STATUS_RETRYING = 1
# two consecutive failures: the numeric limit is latched; no more growth
STATUS_NUMERIC_LIMIT = 2

STATUS_NAMES = {
    STATUS_OK: "ok",
    STATUS_RETRYING: "retrying",
    STATUS_NUMERIC_LIMIT: "numeric_limit",
}
