from .checkpoint import config_tag, load_params, load_state, save_params, save_state
from .errors import (STATUS_NAMES, STATUS_NUMERIC_LIMIT, STATUS_OK, STATUS_RETRYING, TOL,
                     NumericalPrecisionError, get_tolerance, set_tolerance)
from .logging import get_logger, set_verbosity
from .opt import nn_adam, step_schedule
from .prng import KeySequence, key_from_seed
from .profiling import Timings, annotate, trace

_EXPORT = ("exporting the build is not ported yet (ROADMAP Queue A item 13, export): "
           "it waits on K1 as a torch.library custom op and on the build loop's form")


def export_program(*args, **kwargs):
    """A serialized build program (the JAX package's utils/export.py). Not
    ported yet."""
    raise NotImplementedError(_EXPORT)


def export_incremental_build(*args, **kwargs):
    """The incremental build as a serialized program (the JAX package's
    utils/export.py). Not ported yet."""
    raise NotImplementedError(_EXPORT)


def load_program(*args, **kwargs):
    """Loads a serialized build program (the JAX package's utils/export.py).
    Not ported yet."""
    raise NotImplementedError(_EXPORT)


__all__ = ["config_tag", "load_params", "load_state", "save_params", "save_state",
           "STATUS_NAMES", "STATUS_NUMERIC_LIMIT", "STATUS_OK", "STATUS_RETRYING", "TOL",
           "NumericalPrecisionError", "get_tolerance", "set_tolerance",
           "get_logger", "set_verbosity", "nn_adam", "step_schedule",
           "KeySequence", "key_from_seed", "Timings", "annotate", "trace",
           "export_incremental_build", "export_program", "load_program"]
