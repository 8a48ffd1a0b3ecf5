"""Evaluation metrics (counterpart of betacores_tpu/evaluation): the
logistic posterior's test accuracy and predictive log-likelihood over
posterior samples. The Gaussian metrics wait for the Gaussian family."""

from ..models.logreg import compute_accuracy, predictive_loglik

__all__ = ["compute_accuracy", "predictive_loglik"]
