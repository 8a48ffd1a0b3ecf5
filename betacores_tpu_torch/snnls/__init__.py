"""Sparse non-negative least-squares solvers (counterpart of
betacores_tpu/snnls): the greedy GIGA, Frank-Wolfe, orthogonal matching
pursuit and least-angle solvers over one build driver, accelerated IHT,
the sampling baselines and the FISTA NNLS they share. Every solver runs on
the device of its ``A``."""

from .base import BuildState, SparseNNLS, build, optimize
from .frankwolfe import FrankWolfe, fw_precompute, fw_step
from .giga import GIGA, giga_precompute, giga_step
from .iht import AccIHT, aiht_solve, project_nonneg_topk
from .lar import LAR, lar_step
from .nnls import nnls_fista, nnls_on_support
from .orthopursuit import OrthoPursuit, omp_step
from .sampling import (ImportanceSampling, UniformSampling, sampling_build,
                       sampling_draws, sampling_fold)

__all__ = [
    "BuildState",
    "LAR",
    "SparseNNLS",
    "build",
    "optimize",
    "FrankWolfe",
    "fw_precompute",
    "fw_step",
    "AccIHT",
    "aiht_solve",
    "project_nonneg_topk",
    "GIGA",
    "giga_precompute",
    "giga_step",
    "nnls_fista",
    "nnls_on_support",
    "OrthoPursuit",
    "omp_step",
    "ImportanceSampling",
    "UniformSampling",
    "sampling_build",
    "sampling_draws",
    "sampling_fold",
]
