from .checkpoint import config_tag, load_params, load_state, save_params, save_state
from .export import (BuildDraws, build_program, export_incremental_build, export_program,
                     fixed_draws, load_program, load_program_file, save_program, stack_draws)
from .errors import (STATUS_NAMES, STATUS_NUMERIC_LIMIT, STATUS_OK, STATUS_RETRYING, TOL,
                     NumericalPrecisionError, get_tolerance, set_tolerance)
from .logging import get_logger, set_verbosity
from .opt import nn_adam, step_schedule
from .prng import KeySequence, key_from_seed
from .profiling import Timings, annotate, trace

__all__ = ["config_tag", "load_params", "load_state", "save_params", "save_state",
           "STATUS_NAMES", "STATUS_NUMERIC_LIMIT", "STATUS_OK", "STATUS_RETRYING", "TOL",
           "NumericalPrecisionError", "get_tolerance", "set_tolerance",
           "get_logger", "set_verbosity", "nn_adam", "step_schedule",
           "KeySequence", "key_from_seed", "Timings", "annotate", "trace",
           "BuildDraws", "build_program", "export_incremental_build", "export_program",
           "fixed_draws", "load_program", "load_program_file", "save_program", "stack_draws"]
