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
