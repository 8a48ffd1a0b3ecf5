from .perturb import flip_labels, perturb_logreg
from .synthetic import gen_synthetic_logreg, gen_synthetic_multiclass

__all__ = ["flip_labels", "perturb_logreg", "gen_synthetic_logreg",
           "gen_synthetic_multiclass"]
