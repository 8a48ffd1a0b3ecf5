from .laplace import LaplaceApprox, newton_laplace, sample_laplace_from_noise
from .samplers import LogregLaplaceSampler, logreg_laplace_sampler

__all__ = ["LaplaceApprox", "newton_laplace", "sample_laplace_from_noise",
           "LogregLaplaceSampler", "logreg_laplace_sampler"]
