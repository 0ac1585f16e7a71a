"""qinfer_tpu_torch: the PyTorch + CUDA port of :mod:`qinfer_tpu`.

A second package beside the JAX one, which stays the reference. Four
slices are ported: the precession SMC main path (models, the uniform
prior, the SMC updater with Liu-West resampling, the PGH heuristic,
``perf_test`` and the benchmark), tomography
(:mod:`qinfer_tpu_torch.tomography`: bases, priors, state, process and
diffusive models, heuristics; ``tomography_bench``), resample-move
(``BinomialModel`` and :mod:`qinfer_tpu_torch.rejuvenation`: fixed,
adaptive and waste-free Metropolis moves) and experiment design
(:mod:`qinfer_tpu_torch.expdesign`: information gain and Bayes risk
scores, selection policies, the pool and field designers;
``expdesign_bench``), with the hot kernels
hand-written in CUDA for Hopper (:mod:`qinfer_tpu_torch.ops`). Module
names mirror the JAX package. Importing the package builds no kernel and
imports no JAX.
"""

from .config import EPS
from ._exceptions import ResamplerWarning, ZeroWeightError, ZeroWeightWarning
from .domains import Domain, IntegerDomain, RealDomain
from .abstract_model import FiniteOutcomeModel, Model, Simulatable
from .distributions import Distribution, UniformDistribution
from .test_models import CoinModel, SimplePrecessionModel
from .derived_models import BinomialModel, DerivedModel
from .utils import (
    binomial_pdf,
    log_binomial_pdf,
    n_ess,
    particle_covariance_mtx,
    particle_mean,
    sqrtm_psd,
    weighted_moments,
)
from .resamplers import LiuWestResampler, Resampler
from .smc import SMCState, SMCUpdater
from .heuristics import PGH, Heuristic
from .finite_difference import FiniteDifference
from .expdesign import (ExperimentDesigner, OptimizationAlgorithms,
                        PoolDesigner, design_from_candidates,
                        select_candidate)
from .perf_testing import perf_test
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
    "Distribution",
    "UniformDistribution",
    "SimplePrecessionModel",
    "CoinModel",
    "DerivedModel",
    "BinomialModel",
    "binomial_pdf",
    "log_binomial_pdf",
    "n_ess",
    "particle_covariance_mtx",
    "particle_mean",
    "sqrtm_psd",
    "weighted_moments",
    "Resampler",
    "LiuWestResampler",
    "SMCState",
    "SMCUpdater",
    "Heuristic",
    "PGH",
    "FiniteDifference",
    "ExperimentDesigner",
    "OptimizationAlgorithms",
    "PoolDesigner",
    "design_from_candidates",
    "select_candidate",
    "perf_test",
    "AcceleratedPrecessionModel",
    "rejuvenation",
    "tomography",
]
