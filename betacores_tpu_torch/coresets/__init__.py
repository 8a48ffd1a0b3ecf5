from .incremental import (FixedDraws, GeneratorDraws, IncrementalBuilder,
                          IncrementalConfig, make_incremental_builder,
                          make_tangent_error)
from .state import (CoresetState, get, init_state, state_from_numpy,
                    state_to_numpy)

__all__ = ["FixedDraws", "GeneratorDraws", "IncrementalBuilder",
           "IncrementalConfig", "make_incremental_builder", "make_tangent_error",
           "CoresetState",
           "get", "init_state", "state_from_numpy", "state_to_numpy"]
