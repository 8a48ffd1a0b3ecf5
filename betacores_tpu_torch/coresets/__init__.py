from .incremental import (FixedDraws, GeneratorDraws, IncrementalBuilder,
                          IncrementalConfig, make_incremental_builder)
from .state import (CoresetState, get, init_state, state_from_numpy,
                    state_to_numpy)

__all__ = ["FixedDraws", "GeneratorDraws", "IncrementalBuilder",
           "IncrementalConfig", "make_incremental_builder", "CoresetState",
           "get", "init_state", "state_from_numpy", "state_to_numpy"]
