from . import logreg, multiclass
from .base import ModelFns

__all__ = ["logreg", "multiclass", "ModelFns"]
