from . import native_loader
from .loaders import (add_intercept, groups_pickle_path, load_groups_pickle, load_npz,
                      load_uci_regression, make_random_groups, reference_dataset_path,
                      standardize, std_cov)
from .perturb import (RegressionCorruption, apply_regression_corruption,
                      draw_regression_corruption, flip_labels, perturb_groups,
                      perturb_logreg, perturb_regression)
from .synthetic import (gen_synthetic_gaussian, gen_synthetic_linreg, gen_synthetic_logreg,
                        gen_synthetic_multiclass, gen_synthetic_poisson)

__all__ = ["native_loader", "add_intercept", "groups_pickle_path", "load_groups_pickle",
           "load_npz", "load_uci_regression", "reference_dataset_path", "std_cov",
           "RegressionCorruption", "apply_regression_corruption",
           "draw_regression_corruption", "flip_labels", "make_random_groups", "perturb_groups", "perturb_logreg", "perturb_regression",
           "standardize", "gen_synthetic_gaussian", "gen_synthetic_linreg",
           "gen_synthetic_logreg", "gen_synthetic_multiclass", "gen_synthetic_poisson"]
