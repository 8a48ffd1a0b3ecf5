from .api import (BatchPSVICoreset, BetaBlackBoxProjector, BetaCoreset,
                  BlackBoxProjector, ContextualProjector, Coreset, HilbertCoreset,
                  SparseVICoreset, UniformSamplingCoreset, uniform_coreset_draws,
                  weighted_coreset_draws)
from .bpsvi import BPSVIConfig, BPSVIDraws, bpsvi_build_batch, make_bpsvi_builder
from .dpbpsvi import (DiffPrivBatchPSVICoreset, DPConfig, DPDraws, gaussian_rdp_epsilon,
                      make_dp_bpsvi_builder, poisson_batch_cap, poisson_overflow_p, sgm_rdp,
                      subsampled_gaussian_epsilon)
from .groups import (ONEHOT_MAX_BYTES, GroupCoresetState, group_ids_from_groups,
                     init_group_state, make_group_incremental_builder)
from .incremental import (FixedDraws, GeneratorDraws, IncrementalBuilder,
                          IncrementalConfig, make_incremental_builder,
                          make_tangent_error)
from .psvi import PseudoSparseVICoreset, make_psvi_builder
from .refine import refine_weights
from .select_beta import driver_select_beta, padded_scorer, select_beta, trimmed_mean
from .state import (CoresetState, get, group_state_from_numpy, init_state,
                    state_from_numpy, state_to_numpy, warm_start_state)

__all__ = ["BatchPSVICoreset", "BetaBlackBoxProjector", "BetaCoreset",
           "BlackBoxProjector", "ContextualProjector", "Coreset", "HilbertCoreset",
           "SparseVICoreset", "UniformSamplingCoreset", "uniform_coreset_draws",
           "weighted_coreset_draws",
           "BPSVIConfig", "BPSVIDraws", "bpsvi_build_batch", "make_bpsvi_builder",
           "DiffPrivBatchPSVICoreset", "DPConfig", "DPDraws", "gaussian_rdp_epsilon",
           "make_dp_bpsvi_builder", "poisson_batch_cap", "poisson_overflow_p", "sgm_rdp",
           "subsampled_gaussian_epsilon", "ONEHOT_MAX_BYTES", "GroupCoresetState",
           "group_ids_from_groups", "init_group_state", "make_group_incremental_builder",
           "PseudoSparseVICoreset", "make_psvi_builder", "group_state_from_numpy",
           "FixedDraws", "GeneratorDraws", "IncrementalBuilder",
           "IncrementalConfig", "make_incremental_builder", "make_tangent_error",
           "refine_weights", "driver_select_beta", "padded_scorer", "select_beta", "trimmed_mean",
           "CoresetState", "get", "init_state", "state_from_numpy", "state_to_numpy",
           "warm_start_state"]
