"""Evaluation metrics (counterpart of betacores_tpu/evaluation)."""

from .metrics import (compute_accuracy, gaussian_KL, predictive_loglik, regression_rmse_nll,
                      reverse_forward_kl)

__all__ = ["compute_accuracy", "gaussian_KL", "predictive_loglik", "regression_rmse_nll",
           "reverse_forward_kl"]
