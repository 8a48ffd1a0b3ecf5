"""betacores_tpu_torch: the PyTorch/CUDA port of betacores_tpu.

Ported so far: the beta-Cores incremental build (select over a subsample
or every row, refinement on a subsample) for logistic regression, whose
refinement step runs as one hand-written Hopper kernel
(csrc/logreg_adam_step.cu), and for multiclass softmax regression, whose
large projections run as another (csrc/multiclass_projection.cu) and whose
refinement takes the composed route through ``utils.opt.nn_adam``; full-data
refinement and base-data weights; and the sharded build on
``torch.distributed`` (``parallel``: one process per mesh rank, the data
rows over the ``data`` axis and the samples over ``samp``), whose logistic
refinement step runs its shard-local half as a third kernel
(csrc/logreg_shard_partials.cu). On a CUDA device the subsampled
refinement passes run as replayed CUDA graphs over static per-builder
buffers (``utils.graphs``; the builders' ``graph`` argument), where the
reference's build is one jitted program. ``bench_torch.py`` at the root of
the repository is the headline entry point.

The reference's object API is the user's entry point, exported here as the
JAX package exports it: ``BetaCoreset``, ``SparseVICoreset`` (both with
``learn_beta``, ``build_trace``, ``optimize()`` with rollback) and
``UniformSamplingCoreset`` over ``BlackBoxProjector`` /
``BetaBlackBoxProjector``, with ``select_beta``; they run on the card unless
given ``device="cpu"``. The model families of the reference's experiments
are ported with their samplers: the known-covariance Gaussian
(``models.gaussian``, ``gaussian_conjugate_sampler``), linear regression
(``models.linreg``, ``linreg_conjugate_sampler``), Poisson regression
(``models.poisson``, ``poisson_laplace_sampler``) and the unknown-covariance
Gaussian (``models.mvn``, ``mvn.mvn_niw_sampler``, which the builders run on
their per-step-draw route). The Hilbert coresets are ported too: the sparse
NNLS solvers (``snnls``), ``HilbertCoreset``, the weight polish ``refine()``
(``coresets.refine_weights``) and the sharded Hilbert build
(``parallel.ShardedHilbertCoreset``). Group (batch) selection is ported
(``groups=`` on ``BetaCoreset``, ``SparseVICoreset`` and
``UniformSamplingCoreset``; ``coresets.make_group_incremental_builder``,
whose multiclass select runs the projection kernel over every row), with
the pseudo-coresets (``BatchPSVICoreset``, ``DiffPrivBatchPSVICoreset``,
``PseudoSparseVICoreset``) and group data valuation (``valuation``:
distributional and truncated Monte-Carlo Shapley). The neural-linear model
is ported (``models.neural_linear``: an encoder under an exact Bayesian
last layer, trained with ``torch.optim``), with the contextual builds it
drives (``coresets.ContextualProjector`` and ``alg.ctx``; the builders'
``contextual=``) and the example's data helpers (``data.standardize``,
``make_random_groups``, ``perturb_groups``, ``perturb_regression``). The evaluation of a coreset by MCMC is ported
(``inference``: adaptive HMC, iterative NUTS, split-R-hat and ESS, the
HMC-to-NUTS escalation) with the sparse Hamiltonian flows (``inference.shf``);
on a CUDA device their iterations replay as CUDA graphs.
The experiment drivers are ``betacores_tpu_torch.examples`` (each JAX
driver's flags, files and keys, plus ``--device`` and ``--seed``), and
``betacores_tpu_torch.entry`` holds ``entry()`` and ``dryrun_multichip(n)``.
Modules keep the JAX package's paths and names.
This package imports torch and never jax.
"""

from ._lazy import lazy_namespace

_NAMES = {
    "coresets": ("BatchPSVICoreset", "BetaBlackBoxProjector", "BetaCoreset", "BlackBoxProjector",
                 "CoresetState", "DiffPrivBatchPSVICoreset", "FixedDraws", "GeneratorDraws",
                 "HilbertCoreset", "IncrementalConfig", "PseudoSparseVICoreset", "SparseVICoreset",
                 "UniformSamplingCoreset", "init_state", "make_incremental_builder", "select_beta",
                 "state_from_numpy", "state_to_numpy", "trimmed_mean",),
    "data": ("flip_labels", "gen_synthetic_gaussian", "gen_synthetic_linreg",
             "gen_synthetic_logreg", "gen_synthetic_multiclass", "gen_synthetic_poisson",
             "perturb_logreg",),
    "inference": ("fixed_sampler", "gaussian_conjugate_sampler", "linreg_conjugate_sampler",
                  "logreg_laplace_sampler", "multiclass_laplace_sampler", "poisson_laplace_sampler",
                  "prior_gaussian_sampler",),
    "models": ("gaussian", "linreg", "logreg", "multiclass", "mvn", "neural_linear", "poisson",),
    "parallel": ("make_mesh", "make_sharded_incremental_builder", "shard_data", "shard_weights",),
    "utils": ("NumericalPrecisionError", "set_tolerance", "set_verbosity",),
}

__all__ = ["coresets", "data", "evaluation", "inference", "models", "ops", "parallel", "snnls",
           "utils", "valuation", "BatchPSVICoreset", "DiffPrivBatchPSVICoreset",
           "PseudoSparseVICoreset", "BetaBlackBoxProjector", "BetaCoreset", "BlackBoxProjector",
           "HilbertCoreset", "SparseVICoreset", "UniformSamplingCoreset", "select_beta",
           "trimmed_mean", "NumericalPrecisionError", "set_tolerance", "set_verbosity",
           "CoresetState", "FixedDraws", "GeneratorDraws", "IncrementalConfig", "init_state",
           "make_incremental_builder", "state_from_numpy", "state_to_numpy", "flip_labels",
           "gen_synthetic_gaussian", "gen_synthetic_linreg", "gen_synthetic_logreg",
           "gen_synthetic_multiclass", "gen_synthetic_poisson", "perturb_logreg", "fixed_sampler",
           "gaussian_conjugate_sampler", "linreg_conjugate_sampler", "logreg_laplace_sampler",
           "multiclass_laplace_sampler", "poisson_laplace_sampler", "prior_gaussian_sampler",
           "gaussian", "linreg", "logreg", "multiclass", "mvn", "neural_linear", "poisson",
           "make_mesh", "make_sharded_incremental_builder", "shard_data", "shard_weights"]

__getattr__, __dir__ = lazy_namespace(
    __name__, _NAMES, ("coresets", "data", "evaluation", "inference", "models", "ops",
    "parallel", "snnls", "utils", "valuation"))
