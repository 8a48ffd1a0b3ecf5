from .errors import NumericalPrecisionError, get_tolerance, set_tolerance
from .logging import get_logger, set_verbosity
from .opt import nn_adam, step_schedule
from .prng import KeySequence

__all__ = ["NumericalPrecisionError", "get_tolerance", "set_tolerance",
           "get_logger", "set_verbosity", "nn_adam", "step_schedule", "KeySequence"]
