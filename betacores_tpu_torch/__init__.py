"""betacores_tpu_torch: the PyTorch/CUDA port of betacores_tpu.

Slice 1 is ported: the beta-Cores incremental build on logistic regression
with a Laplace posterior, whose refinement step runs as one hand-written
Hopper kernel (csrc/logreg_adam_step.cu). Modules keep the JAX package's
paths and names. This package imports torch and never jax.
"""

from . import coresets, data, inference, models, ops, utils
from .coresets import (CoresetState, FixedDraws, GeneratorDraws,
                       IncrementalConfig, init_state, make_incremental_builder,
                       state_from_numpy, state_to_numpy)
from .data import gen_synthetic_logreg, perturb_logreg
from .inference import logreg_laplace_sampler
from .models import logreg

__all__ = [
    "coresets", "data", "inference", "models", "ops", "utils",
    "CoresetState", "FixedDraws", "GeneratorDraws", "IncrementalConfig",
    "init_state", "make_incremental_builder", "state_from_numpy",
    "state_to_numpy", "gen_synthetic_logreg", "perturb_logreg",
    "logreg_laplace_sampler", "logreg",
]
