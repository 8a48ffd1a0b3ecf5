from .loaders import make_random_groups, standardize
from .perturb import (RegressionCorruption, apply_regression_corruption,
                      draw_regression_corruption, flip_labels, perturb_groups,
                      perturb_logreg, perturb_regression)
from .synthetic import (gen_synthetic_gaussian, gen_synthetic_linreg, gen_synthetic_logreg,
                        gen_synthetic_multiclass, gen_synthetic_poisson)

__all__ = ["RegressionCorruption", "apply_regression_corruption",
           "draw_regression_corruption", "flip_labels", "make_random_groups", "perturb_groups", "perturb_logreg", "perturb_regression",
           "standardize", "gen_synthetic_gaussian", "gen_synthetic_linreg",
           "gen_synthetic_logreg", "gen_synthetic_multiclass", "gen_synthetic_poisson"]
