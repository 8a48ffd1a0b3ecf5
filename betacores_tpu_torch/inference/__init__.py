from .laplace import (LaplaceApprox, newton_laplace, newton_laplace_diag,
                      sample_laplace_from_noise)
from .samplers import (FixedSampler, GaussianConjugateSampler, LinregConjugateSampler,
                       LogregDiagLaplaceSampler, LogregLaplaceSampler,
                       MulticlassLaplaceSampler, PoissonDiagLaplaceSampler,
                       PoissonLaplaceSampler, PriorGaussianSampler, fixed_sampler,
                       gaussian_conjugate_sampler, linreg_conjugate_sampler,
                       logreg_laplace_sampler, multiclass_laplace_sampler,
                       poisson_laplace_sampler, prior_gaussian_sampler)

__all__ = ["LaplaceApprox", "newton_laplace", "newton_laplace_diag",
           "sample_laplace_from_noise", "FixedSampler", "fixed_sampler",
           "GaussianConjugateSampler", "gaussian_conjugate_sampler",
           "LinregConjugateSampler", "linreg_conjugate_sampler",
           "LogregLaplaceSampler", "LogregDiagLaplaceSampler", "logreg_laplace_sampler",
           "MulticlassLaplaceSampler", "multiclass_laplace_sampler",
           "PoissonLaplaceSampler", "PoissonDiagLaplaceSampler", "poisson_laplace_sampler",
           "PriorGaussianSampler", "prior_gaussian_sampler"]
