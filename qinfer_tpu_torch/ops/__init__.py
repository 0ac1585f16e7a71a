"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 :func:`fused_precession_update`, K2 :func:`precession_pr0`,
K3 :func:`streaming_resample_locations`, the tomography path's Jacobi
kernels K4 :func:`jacobi_project_lanes`, K5
:func:`jacobi_project_lanes_looped` and K6 :func:`jacobi_eigh_lanes`, and
the resampler's counting pass :func:`counting_multiplicities_from_u`."""

from .precession import (
    fused_precession_update,
    fused_precession_update_plain,
    precession_pr0,
    precession_pr0_plain,
)
from .counting_pass import (
    counting_multiplicities_from_u,
    counting_multiplicities_from_u_plain,
)
from .streaming_resample import (
    streaming_resample_locations,
    streaming_resample_locations_plain,
)
from .jacobi import (
    jacobi_eigh_lanes,
    jacobi_eigh_lanes_plain,
    jacobi_project_lanes,
    jacobi_project_lanes_looped,
    jacobi_project_lanes_looped_plain,
    jacobi_project_lanes_plain,
)
from .accelerated import AcceleratedPrecessionModel

__all__ = [
    "fused_precession_update",
    "fused_precession_update_plain",
    "precession_pr0",
    "precession_pr0_plain",
    "streaming_resample_locations",
    "streaming_resample_locations_plain",
    "jacobi_eigh_lanes",
    "jacobi_eigh_lanes_plain",
    "jacobi_project_lanes",
    "jacobi_project_lanes_plain",
    "jacobi_project_lanes_looped",
    "jacobi_project_lanes_looped_plain",
    "counting_multiplicities_from_u",
    "counting_multiplicities_from_u_plain",
    "AcceleratedPrecessionModel",
]
