from .._lazy import lazy_namespace

_NAMES = {
    "api": ("BatchPSVICoreset", "BetaBlackBoxProjector", "BetaCoreset", "BlackBoxProjector",
            "ContextualProjector", "Coreset", "HilbertCoreset", "SparseVICoreset",
            "UniformSamplingCoreset", "uniform_coreset_draws", "weighted_coreset_draws",),
    "bpsvi": ("BPSVIConfig", "BPSVIDraws", "bpsvi_build_batch", "make_bpsvi_builder",),
    "dpbpsvi": ("DiffPrivBatchPSVICoreset", "DPConfig", "DPDraws", "gaussian_rdp_epsilon",
                "make_dp_bpsvi_builder", "poisson_batch_cap", "poisson_overflow_p", "sgm_rdp",
                "subsampled_gaussian_epsilon",),
    "groups": ("ONEHOT_MAX_BYTES", "GroupCoresetState", "group_ids_from_groups",
               "init_group_state", "make_group_incremental_builder",),
    "incremental": ("FixedDraws", "GeneratorDraws", "IncrementalBuilder", "IncrementalConfig",
                    "make_incremental_builder", "make_tangent_error",),
    "psvi": ("PseudoSparseVICoreset", "make_psvi_builder",),
    "refine": ("refine_weights",),
    "select_beta": ("driver_select_beta", "padded_scorer", "select_beta", "trimmed_mean",),
    "streaming": ("merge_reduce_build",),
    "state": ("CoresetState", "get", "group_state_from_numpy", "init_state", "state_from_numpy",
              "state_to_numpy", "warm_start_state",),
}

__all__ = ["BatchPSVICoreset", "BetaBlackBoxProjector", "BetaCoreset", "BlackBoxProjector",
           "ContextualProjector", "Coreset", "HilbertCoreset", "SparseVICoreset",
           "UniformSamplingCoreset", "uniform_coreset_draws", "weighted_coreset_draws",
           "BPSVIConfig", "BPSVIDraws", "bpsvi_build_batch", "make_bpsvi_builder",
           "DiffPrivBatchPSVICoreset", "DPConfig", "DPDraws", "gaussian_rdp_epsilon",
           "make_dp_bpsvi_builder", "poisson_batch_cap", "poisson_overflow_p", "sgm_rdp",
           "subsampled_gaussian_epsilon", "ONEHOT_MAX_BYTES", "GroupCoresetState",
           "group_ids_from_groups", "init_group_state", "make_group_incremental_builder",
           "PseudoSparseVICoreset", "make_psvi_builder", "group_state_from_numpy", "FixedDraws",
           "GeneratorDraws", "IncrementalBuilder", "IncrementalConfig", "make_incremental_builder",
           "make_tangent_error", "merge_reduce_build", "refine_weights", "driver_select_beta",
           "padded_scorer", "select_beta", "trimmed_mean", "CoresetState", "get", "init_state",
           "state_from_numpy", "state_to_numpy", "warm_start_state"]

__getattr__, __dir__ = lazy_namespace(
    __name__, _NAMES, ())
