from .._lazy import lazy_namespace

_NAMES = {
    "diagnostics": ("effective_sample_size", "split_rhat", "summarize_chains",),
    "escalation": ("DEFAULT_ESS_MIN", "DEFAULT_RHAT_MAX", "EvalRun", "default_nuts_config",
                   "diagnostics_failed", "run_with_escalation",),
    "hmc": ("HMCConfig", "HMCDraws", "HMCPhaseDraws", "draw_hmc", "hmc_sample",
            "hmc_sample_full_logreg", "hmc_sample_weighted_logreg",
            "hmc_sample_weighted_poisson", "make_weighted_hmc", "run_chains",
            "run_chains_sharded", "run_chains_weighted_logreg", "run_chains_weighted_poisson",
            "weighted_logreg_logprob",),
    "laplace": ("LaplaceApprox", "newton_laplace", "newton_laplace_diag",
                "sample_laplace", "sample_laplace_from_noise",),
    "nuts": ("NUTSConfig", "NUTSDraws", "NUTSPhaseDraws", "draw_nuts", "make_weighted_nuts",
             "nuts_sample", "run_chains_nuts", "run_chains_weighted_logreg_nuts",),
    "samplers": ("FixedSampler", "GaussianConjugateSampler", "LinregConjugateSampler",
                 "LogregDiagLaplaceSampler", "LogregLaplaceSampler", "MulticlassLaplaceSampler",
                 "PoissonDiagLaplaceSampler", "PoissonLaplaceSampler", "PriorGaussianSampler",
                 "fixed_sampler", "gaussian_conjugate_sampler", "linreg_conjugate_sampler",
                 "logreg_laplace_sampler", "multiclass_laplace_sampler", "poisson_laplace_sampler",
                 "prior_gaussian_sampler",),
    "shf": ("SHFConfig", "SHFDraws", "SHFParams", "beta_log_joint", "draw_shf",
            "gaussian_log_joint", "init_shf_params", "make_sharded_shf_trainer",
            "make_shf_trainer", "shf_sample",),
}

__all__ = ["hmc", "HMCConfig", "HMCDraws", "HMCPhaseDraws", "draw_hmc", "hmc_sample",
           "hmc_sample_full_logreg", "hmc_sample_weighted_logreg", "hmc_sample_weighted_poisson",
           "make_weighted_hmc", "run_chains", "run_chains_sharded", "run_chains_weighted_logreg",
           "run_chains_weighted_poisson", "weighted_logreg_logprob", "NUTSConfig", "NUTSDraws",
           "NUTSPhaseDraws", "draw_nuts", "make_weighted_nuts", "nuts_sample", "run_chains_nuts",
           "run_chains_weighted_logreg_nuts", "effective_sample_size", "split_rhat",
           "summarize_chains", "DEFAULT_ESS_MIN", "DEFAULT_RHAT_MAX", "EvalRun",
           "default_nuts_config", "diagnostics_failed", "run_with_escalation", "SHFConfig",
           "SHFDraws", "SHFParams", "beta_log_joint", "draw_shf", "gaussian_log_joint",
           "init_shf_params", "make_sharded_shf_trainer", "make_shf_trainer", "shf_sample",
           "LaplaceApprox", "newton_laplace", "newton_laplace_diag", "sample_laplace",
           "sample_laplace_from_noise",
           "FixedSampler", "fixed_sampler", "GaussianConjugateSampler",
           "gaussian_conjugate_sampler", "LinregConjugateSampler", "linreg_conjugate_sampler",
           "LogregLaplaceSampler", "LogregDiagLaplaceSampler", "logreg_laplace_sampler",
           "MulticlassLaplaceSampler", "multiclass_laplace_sampler", "PoissonLaplaceSampler",
           "PoissonDiagLaplaceSampler", "poisson_laplace_sampler", "PriorGaussianSampler",
           "prior_gaussian_sampler"]

__getattr__, __dir__ = lazy_namespace(
    __name__, _NAMES, ("hmc",))
