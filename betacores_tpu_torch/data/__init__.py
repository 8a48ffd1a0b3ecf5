from .perturb import perturb_logreg
from .synthetic import gen_synthetic_logreg

__all__ = ["perturb_logreg", "gen_synthetic_logreg"]
