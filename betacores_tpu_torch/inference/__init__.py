from .laplace import LaplaceApprox, newton_laplace, sample_laplace_from_noise
from .samplers import (LogregLaplaceSampler, MulticlassLaplaceSampler,
                       logreg_laplace_sampler, multiclass_laplace_sampler)

__all__ = ["LaplaceApprox", "newton_laplace", "sample_laplace_from_noise",
           "LogregLaplaceSampler", "logreg_laplace_sampler",
           "MulticlassLaplaceSampler", "multiclass_laplace_sampler"]
