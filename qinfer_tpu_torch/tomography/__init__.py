"""Quantum state and process tomography (counterpart of
:mod:`qinfer_tpu.tomography`, without its plotting tools): operator bases
with the real embedding, density-operator priors, the likelihood models
whose PSD projection runs the Jacobi kernels K4/K5, and the measurement
heuristics."""

from .bases import (
    TomographyBasis,
    pauli_basis,
    gell_mann_basis,
    tensor_product_basis,
)
from .distributions import (
    DensityOperatorDistribution,
    GinibreDistribution,
    GinibreReditDistribution,
    BCSZChoiDistribution,
    GADFLIDistribution,
)
from .models import (TomographyModel, DiffusiveTomographyModel,
                     ProcessTomographyModel)
from .expdesign import (
    RandomPauliHeuristic,
    RandomStabilizerStateHeuristic,
    ProductHeuristic,
    BestOfKMetaheuristic,
)

__all__ = [
    "TomographyBasis",
    "pauli_basis",
    "gell_mann_basis",
    "tensor_product_basis",
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
    "TomographyModel",
    "DiffusiveTomographyModel",
    "ProcessTomographyModel",
    "RandomPauliHeuristic",
    "RandomStabilizerStateHeuristic",
    "ProductHeuristic",
    "BestOfKMetaheuristic",
]
