from .._lazy import lazy_namespace

_NAMES = {
    "base": ("ModelFns",),
}

__all__ = ["gaussian", "linreg", "logreg", "multiclass", "mvn", "neural_linear", "poisson",
           "ModelFns"]

__getattr__, __dir__ = lazy_namespace(
    __name__, _NAMES, ("gaussian", "linreg", "logreg", "multiclass", "mvn", "poisson",
    "neural_linear"))
