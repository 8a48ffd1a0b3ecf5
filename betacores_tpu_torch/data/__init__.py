from .perturb import flip_labels, perturb_logreg
from .synthetic import (gen_synthetic_gaussian, gen_synthetic_linreg, gen_synthetic_logreg,
                        gen_synthetic_multiclass, gen_synthetic_poisson)

__all__ = ["flip_labels", "perturb_logreg", "gen_synthetic_gaussian", "gen_synthetic_linreg",
           "gen_synthetic_logreg", "gen_synthetic_multiclass", "gen_synthetic_poisson"]
