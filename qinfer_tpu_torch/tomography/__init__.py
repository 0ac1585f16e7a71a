"""Quantum state and process tomography (counterpart of
:mod:`qinfer_tpu.tomography`): operator bases with the real embedding,
density-operator priors, the likelihood models whose PSD projection runs
the Jacobi kernels K4/K5, the measurement heuristics and the plotting
tools (matplotlib imported at call time)."""

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
from .plotting_tools import (
    rebit_coords,
    plot_rebit_posterior,
    plot_decaying_exponentials,
)
from .expdesign import (
    RandomPauliHeuristic,
    RandomStabilizerStateHeuristic,
    ProductHeuristic,
    BestOfKMetaheuristic,
)

__all__ = [
    "rebit_coords",
    "plot_rebit_posterior",
    "plot_decaying_exponentials",
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
