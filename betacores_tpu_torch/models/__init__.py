from . import gaussian, linreg, logreg, multiclass, mvn, poisson
from . import neural_linear  # after the families: it builds on linreg's sampler
from .base import ModelFns

__all__ = ["gaussian", "linreg", "logreg", "multiclass", "mvn", "neural_linear", "poisson",
           "ModelFns"]
