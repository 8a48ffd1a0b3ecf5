from . import gaussian, linreg, logreg, multiclass, mvn, poisson
from .base import ModelFns

__all__ = ["gaussian", "linreg", "logreg", "multiclass", "mvn", "poisson", "ModelFns"]
