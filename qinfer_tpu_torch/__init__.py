"""qinfer_tpu_torch: the PyTorch + CUDA port of :mod:`qinfer_tpu`.

A second package beside the JAX one, which stays the reference. This
slice is the precession SMC main path: models, the uniform prior, the SMC
updater with Liu-West resampling, the PGH heuristic, ``perf_test`` and
the benchmark, with the three hot kernels hand-written in CUDA for Hopper
(:mod:`qinfer_tpu_torch.ops`). Module names mirror the JAX package.
Importing the package builds no kernel and imports no JAX.
"""

from .config import EPS
from ._exceptions import ResamplerWarning, ZeroWeightError, ZeroWeightWarning
from .domains import Domain, IntegerDomain, RealDomain
from .abstract_model import FiniteOutcomeModel, Model, Simulatable
from .distributions import Distribution, UniformDistribution
from .test_models import SimplePrecessionModel
from .utils import (
    n_ess,
    particle_covariance_mtx,
    particle_mean,
    sqrtm_psd,
    weighted_moments,
)
from .resamplers import LiuWestResampler, Resampler
from .smc import SMCState, SMCUpdater
from .heuristics import PGH, Heuristic
from .perf_testing import perf_test
from .ops.accelerated import AcceleratedPrecessionModel

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
    "perf_test",
    "AcceleratedPrecessionModel",
]
