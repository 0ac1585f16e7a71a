"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 :func:`fused_precession_update`, K2 :func:`precession_pr0`,
K3 :func:`streaming_resample_locations`."""

from .precession import (
    fused_precession_update,
    fused_precession_update_plain,
    precession_pr0,
    precession_pr0_plain,
)
from .streaming_resample import (
    streaming_resample_locations,
    streaming_resample_locations_plain,
)
from .accelerated import AcceleratedPrecessionModel

__all__ = [
    "fused_precession_update",
    "fused_precession_update_plain",
    "precession_pr0",
    "precession_pr0_plain",
    "streaming_resample_locations",
    "streaming_resample_locations_plain",
    "AcceleratedPrecessionModel",
]
