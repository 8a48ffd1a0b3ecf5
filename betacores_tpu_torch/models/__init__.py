from . import logreg
from .base import ModelFns

__all__ = ["logreg", "ModelFns"]
