from .laplace import (LaplaceApprox, newton_laplace, newton_laplace_diag,
                      sample_laplace_from_noise)
from .samplers import (FixedSampler, LogregDiagLaplaceSampler, LogregLaplaceSampler,
                       MulticlassLaplaceSampler, fixed_sampler, logreg_laplace_sampler,
                       multiclass_laplace_sampler)

__all__ = ["LaplaceApprox", "newton_laplace", "newton_laplace_diag",
           "sample_laplace_from_noise", "FixedSampler", "fixed_sampler",
           "LogregLaplaceSampler", "LogregDiagLaplaceSampler", "logreg_laplace_sampler",
           "MulticlassLaplaceSampler", "multiclass_laplace_sampler"]
