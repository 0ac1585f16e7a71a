"""qinfer_tpu_torch: the PyTorch + CUDA port of :mod:`qinfer_tpu`.

A second package beside the JAX one, which stays the reference. Every
module is ported: the precession SMC main path (models, the uniform
prior, the SMC updater with Liu-West resampling, the PGH heuristic,
``perf_test`` and the benchmark), tomography
(:mod:`qinfer_tpu_torch.tomography`: bases, priors, state, process and
diffusive models, heuristics; ``tomography_bench``), resample-move
(``BinomialModel`` and :mod:`qinfer_tpu_torch.rejuvenation`: fixed,
adaptive and waste-free Metropolis moves) and experiment design
(:mod:`qinfer_tpu_torch.expdesign`: information gain and Bayes risk
scores, selection policies, the pool and field designers;
``expdesign_bench``) and batch estimation (``SMCUpdater.batch_update``,
the posterior and region estimators, ``SMCUpdaterBCRB``, differentiable
models, the Ramsey and randomized-benchmarking models, ``simple_est``,
``perf_test_multiple`` and ``models_bench``) and the remaining models,
distributions and heuristics (the derived models, vector-outcome
``MultinomialModel``, approximate likelihood estimation in :mod:`.ale`,
the prior families, ``ExpSparseHeuristic``, the GADFLI prior;
``item8_bench``) and the trial engines (``perf_test_scan``,
``perf_test_scan_batch``; ``trials_bench``), checkpoint and resume
(:mod:`.checkpoint`), the auxiliaries (clustering, metrics, progress
bars, plots) and the particle mesh (:mod:`.parallel`: a mesh of shards
in one process, the two-level distributed Liu-West resampler, the
engine-pool model; ``scaling_bench``), with the hot kernels
hand-written in CUDA for Hopper (:mod:`qinfer_tpu_torch.ops`). Module
names mirror the JAX package. Importing the package builds no kernel and
imports no JAX.
"""

from .version import __version__, version
from .config import EPS, default_dtype, default_int_dtype, set_default_dtype
from ._exceptions import (ApproximationWarning, PerformanceWarning,
                          ResamplerError, ResamplerWarning, ZeroWeightError,
                          ZeroWeightWarning)
from .domains import Domain, IntegerDomain, MultinomialDomain, RealDomain
from .abstract_model import (DifferentiableModel, FiniteOutcomeModel, Model,
                             ScoreMixin, Simulatable, dict_to_expparams,
                             expparams_to_dict)
from .distributions import (
    BetaBinomialDistribution,
    BetaDistribution,
    ConstantDistribution,
    ConstrainedSumDistribution,
    DiscreteUniformDistribution,
    Distribution,
    GammaDistribution,
    GinibreUniform,
    HaarUniform,
    HilbertSchmidtUniform,
    InterpolatedUnivariateDistribution,
    LogNormalDistribution,
    MixtureDistribution,
    MultivariateNormalDistribution,
    MVUniformDistribution,
    NormalDistribution,
    ParticleDistribution,
    PostselectedDistribution,
    ProductDistribution,
    SingleSampleMixin,
    SlantedNormalDistribution,
    UniformDistribution,
)
from .test_models import (CoinModel, MultiCosineModel, NDieModel,
                          NoisyCoinModel, RamseyModel, SimpleInversionModel,
                          SimplePrecessionModel)
from .derived_models import (BinomialModel, DerivedModel,
                             GaussianRandomWalkModel, MLEModel,
                             MultinomialModel, PoisonedModel,
                             RandomWalkModel, ReferencedPoissonModel)
from .ale import ALEApproximateModel, binom_est_error, binom_est_p
from .rb import F_to_p, RandomizedBenchmarkingModel, p_to_F
from .utils import (
    assert_sigfigs_equal,
    binomial_pdf,
    compactspace,
    ellipsoid_volume,
    format_uncertainty,
    from_simplex,
    in_ellipsoid,
    join_struct_arrays,
    log_binomial_pdf,
    multinomial_pdf,
    mvee,
    n_ess,
    outer_product,
    particle_covariance_mtx,
    particle_mean,
    particle_meanfn,
    safe_shape,
    sample_multinomial,
    sqrtm_psd,
    to_simplex,
    uniquify,
    weighted_moments,
)
from .resamplers import LiuWestResampler, Resampler
from .smc import SMCState, SMCUpdater, SMCUpdaterBCRB
from .heuristics import PGH, ExpSparseHeuristic, Heuristic, IdentityHeuristic
from .finite_difference import FiniteDifference
from .expdesign import (ExperimentDesigner, OptimizationAlgorithms,
                        PoolDesigner, design_from_candidates,
                        select_candidate)
from .clustering import NO_CLUSTER, particle_clusters
from .perf_testing import perf_test, perf_test_multiple
from .simple_est import load_data, simple_est_prec, simple_est_rb
from .parallel import (DirectViewParallelizedModel, ParticleMesh,
                       make_particle_sharding)
from .ops.accelerated import AcceleratedPrecessionModel
from .checkpoint import load_updater, save_updater
from .ipy import IPythonProgressBar
from ._due import BibTeX, Doi, due
from . import checkpoint, parallel, perf_testing, rejuvenation, tomography

__all__ = [
    "version",
    "__version__",
    "EPS",
    "default_dtype",
    "default_int_dtype",
    "set_default_dtype",
    "ApproximationWarning",
    "ResamplerError",
    "PerformanceWarning",
    "ResamplerWarning",
    "ZeroWeightError",
    "ZeroWeightWarning",
    "Domain",
    "IntegerDomain",
    "MultinomialDomain",
    "RealDomain",
    "Simulatable",
    "Model",
    "FiniteOutcomeModel",
    "DifferentiableModel",
    "ScoreMixin",
    "expparams_to_dict",
    "dict_to_expparams",
    "Distribution",
    "SingleSampleMixin",
    "UniformDistribution",
    "DiscreteUniformDistribution",
    "MVUniformDistribution",
    "ConstantDistribution",
    "NormalDistribution",
    "MultivariateNormalDistribution",
    "SlantedNormalDistribution",
    "LogNormalDistribution",
    "BetaDistribution",
    "BetaBinomialDistribution",
    "GammaDistribution",
    "InterpolatedUnivariateDistribution",
    "ProductDistribution",
    "MixtureDistribution",
    "PostselectedDistribution",
    "ConstrainedSumDistribution",
    "ParticleDistribution",
    "HaarUniform",
    "GinibreUniform",
    "HilbertSchmidtUniform",
    "SimplePrecessionModel",
    "SimpleInversionModel",
    "CoinModel",
    "NoisyCoinModel",
    "NDieModel",
    "MultiCosineModel",
    "RamseyModel",
    "DerivedModel",
    "PoisonedModel",
    "BinomialModel",
    "MultinomialModel",
    "MLEModel",
    "RandomWalkModel",
    "GaussianRandomWalkModel",
    "ReferencedPoissonModel",
    "ALEApproximateModel",
    "binom_est_p",
    "binom_est_error",
    "RandomizedBenchmarkingModel",
    "p_to_F",
    "F_to_p",
    "binomial_pdf",
    "log_binomial_pdf",
    "multinomial_pdf",
    "sample_multinomial",
    "outer_product",
    "to_simplex",
    "from_simplex",
    "uniquify",
    "assert_sigfigs_equal",
    "format_uncertainty",
    "compactspace",
    "safe_shape",
    "join_struct_arrays",
    "n_ess",
    "particle_covariance_mtx",
    "particle_mean",
    "particle_meanfn",
    "sqrtm_psd",
    "weighted_moments",
    "in_ellipsoid",
    "ellipsoid_volume",
    "mvee",
    "Resampler",
    "LiuWestResampler",
    "SMCState",
    "SMCUpdater",
    "SMCUpdaterBCRB",
    "Heuristic",
    "PGH",
    "ExpSparseHeuristic",
    "IdentityHeuristic",
    "FiniteDifference",
    "ExperimentDesigner",
    "OptimizationAlgorithms",
    "PoolDesigner",
    "design_from_candidates",
    "select_candidate",
    "particle_clusters",
    "NO_CLUSTER",
    "perf_test",
    "perf_test_multiple",
    "simple_est_prec",
    "simple_est_rb",
    "load_data",
    "ParticleMesh",
    "make_particle_sharding",
    "DirectViewParallelizedModel",
    "AcceleratedPrecessionModel",
    "save_updater",
    "load_updater",
    "IPythonProgressBar",
    "due",
    "Doi",
    "BibTeX",
    "checkpoint",
    "parallel",
    "perf_testing",
    "rejuvenation",
    "tomography",
]
