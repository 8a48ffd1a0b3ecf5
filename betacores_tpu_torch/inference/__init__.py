from . import hmc
from .diagnostics import effective_sample_size, split_rhat, summarize_chains
from .escalation import (DEFAULT_ESS_MIN, DEFAULT_RHAT_MAX, EvalRun, default_nuts_config,
                         diagnostics_failed, run_with_escalation)
from .hmc import (HMCConfig, HMCDraws, HMCPhaseDraws, draw_hmc, hmc_sample,
                  hmc_sample_full_logreg, hmc_sample_weighted_logreg,
                  hmc_sample_weighted_poisson, make_weighted_hmc, run_chains,
                  run_chains_sharded, run_chains_weighted_logreg, run_chains_weighted_poisson,
                  weighted_logreg_logprob)
from .laplace import (LaplaceApprox, newton_laplace, newton_laplace_diag,
                      sample_laplace_from_noise)
from .nuts import (NUTSConfig, NUTSDraws, NUTSPhaseDraws, draw_nuts, make_weighted_nuts,
                   nuts_sample, run_chains_nuts, run_chains_weighted_logreg_nuts)
from .samplers import (FixedSampler, GaussianConjugateSampler, LinregConjugateSampler,
                       LogregDiagLaplaceSampler, LogregLaplaceSampler,
                       MulticlassLaplaceSampler, PoissonDiagLaplaceSampler,
                       PoissonLaplaceSampler, PriorGaussianSampler, fixed_sampler,
                       gaussian_conjugate_sampler, linreg_conjugate_sampler,
                       logreg_laplace_sampler, multiclass_laplace_sampler,
                       poisson_laplace_sampler, prior_gaussian_sampler)
from .shf import (SHFConfig, SHFDraws, SHFParams, beta_log_joint, draw_shf, gaussian_log_joint,
                  init_shf_params, make_sharded_shf_trainer, make_shf_trainer, shf_sample)

__all__ = ["hmc", "HMCConfig", "HMCDraws", "HMCPhaseDraws", "draw_hmc", "hmc_sample",
           "hmc_sample_full_logreg", "hmc_sample_weighted_logreg",
           "hmc_sample_weighted_poisson", "make_weighted_hmc", "run_chains",
           "run_chains_sharded", "run_chains_weighted_logreg", "run_chains_weighted_poisson",
           "weighted_logreg_logprob",
           "NUTSConfig", "NUTSDraws", "NUTSPhaseDraws", "draw_nuts", "make_weighted_nuts",
           "nuts_sample", "run_chains_nuts", "run_chains_weighted_logreg_nuts",
           "effective_sample_size", "split_rhat", "summarize_chains",
           "DEFAULT_ESS_MIN", "DEFAULT_RHAT_MAX", "EvalRun", "default_nuts_config",
           "diagnostics_failed", "run_with_escalation",
           "SHFConfig", "SHFDraws", "SHFParams", "beta_log_joint", "draw_shf",
           "gaussian_log_joint", "init_shf_params", "make_sharded_shf_trainer",
           "make_shf_trainer", "shf_sample",
           "LaplaceApprox", "newton_laplace", "newton_laplace_diag",
           "sample_laplace_from_noise", "FixedSampler", "fixed_sampler",
           "GaussianConjugateSampler", "gaussian_conjugate_sampler",
           "LinregConjugateSampler", "linreg_conjugate_sampler",
           "LogregLaplaceSampler", "LogregDiagLaplaceSampler", "logreg_laplace_sampler",
           "MulticlassLaplaceSampler", "multiclass_laplace_sampler",
           "PoissonLaplaceSampler", "PoissonDiagLaplaceSampler", "poisson_laplace_sampler",
           "PriorGaussianSampler", "prior_gaussian_sampler"]
