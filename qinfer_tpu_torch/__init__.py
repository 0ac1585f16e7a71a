"""qinfer_tpu_torch: the PyTorch + CUDA port of :mod:`qinfer_tpu`.

A second package beside the JAX one, which stays the reference. Five
slices are ported: the precession SMC main path (models, the uniform
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
``perf_test_multiple`` and ``models_bench``), with the hot kernels
hand-written in CUDA for Hopper (:mod:`qinfer_tpu_torch.ops`). Module
names mirror the JAX package. Importing the package builds no kernel and
imports no JAX.
"""

from .config import EPS
from ._exceptions import ResamplerWarning, ZeroWeightError, ZeroWeightWarning
from .domains import Domain, IntegerDomain, RealDomain
from .abstract_model import (DifferentiableModel, FiniteOutcomeModel, Model,
                             ScoreMixin, Simulatable)
from .distributions import (Distribution, ParticleDistribution,
                            PostselectedDistribution, UniformDistribution)
from .test_models import (CoinModel, MultiCosineModel, RamseyModel,
                          SimplePrecessionModel)
from .derived_models import BinomialModel, DerivedModel
from .rb import F_to_p, RandomizedBenchmarkingModel, p_to_F
from .utils import (
    binomial_pdf,
    ellipsoid_volume,
    in_ellipsoid,
    log_binomial_pdf,
    mvee,
    n_ess,
    particle_covariance_mtx,
    particle_mean,
    particle_meanfn,
    sqrtm_psd,
    weighted_moments,
)
from .resamplers import LiuWestResampler, Resampler
from .smc import SMCState, SMCUpdater, SMCUpdaterBCRB
from .heuristics import PGH, Heuristic
from .finite_difference import FiniteDifference
from .expdesign import (ExperimentDesigner, OptimizationAlgorithms,
                        PoolDesigner, design_from_candidates,
                        select_candidate)
from .perf_testing import perf_test, perf_test_multiple
from .simple_est import load_data, simple_est_prec, simple_est_rb
from .ops.accelerated import AcceleratedPrecessionModel
from . import rejuvenation, tomography

__all__ = [
    "EPS",
    "ResamplerWarning",
    "ZeroWeightError",
    "ZeroWeightWarning",
    "Domain",
    "IntegerDomain",
    "RealDomain",
    "Simulatable",
    "Model",
    "FiniteOutcomeModel",
    "DifferentiableModel",
    "ScoreMixin",
    "Distribution",
    "UniformDistribution",
    "PostselectedDistribution",
    "ParticleDistribution",
    "SimplePrecessionModel",
    "CoinModel",
    "MultiCosineModel",
    "RamseyModel",
    "DerivedModel",
    "BinomialModel",
    "RandomizedBenchmarkingModel",
    "p_to_F",
    "F_to_p",
    "binomial_pdf",
    "log_binomial_pdf",
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
    "FiniteDifference",
    "ExperimentDesigner",
    "OptimizationAlgorithms",
    "PoolDesigner",
    "design_from_candidates",
    "select_candidate",
    "perf_test",
    "perf_test_multiple",
    "simple_est_prec",
    "simple_est_rb",
    "load_data",
    "AcceleratedPrecessionModel",
    "rejuvenation",
    "tomography",
]
