from .api import (BatchPSVICoreset, BetaBlackBoxProjector, BetaCoreset,
                  BlackBoxProjector, ContextualProjector, Coreset, HilbertCoreset,
                  SparseVICoreset, UniformSamplingCoreset, uniform_coreset_draws,
                  weighted_coreset_draws)
from .incremental import (FixedDraws, GeneratorDraws, IncrementalBuilder,
                          IncrementalConfig, make_incremental_builder,
                          make_tangent_error)
from .refine import refine_weights
from .select_beta import driver_select_beta, padded_scorer, select_beta, trimmed_mean
from .state import (CoresetState, get, init_state, state_from_numpy,
                    state_to_numpy, warm_start_state)

__all__ = ["BatchPSVICoreset", "BetaBlackBoxProjector", "BetaCoreset",
           "BlackBoxProjector", "ContextualProjector", "Coreset", "HilbertCoreset",
           "SparseVICoreset", "UniformSamplingCoreset", "uniform_coreset_draws",
           "weighted_coreset_draws",
           "FixedDraws", "GeneratorDraws", "IncrementalBuilder",
           "IncrementalConfig", "make_incremental_builder", "make_tangent_error",
           "refine_weights", "driver_select_beta", "padded_scorer", "select_beta", "trimmed_mean",
           "CoresetState", "get", "init_state", "state_from_numpy", "state_to_numpy",
           "warm_start_state"]
