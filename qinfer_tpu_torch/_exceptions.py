"""Warnings and exceptions of the port (counterparts of
:mod:`qinfer_tpu._exceptions` used on the SMC main path)."""

__all__ = ["ApproximationWarning", "ResamplerWarning", "ResamplerError",
           "ZeroWeightWarning", "ZeroWeightError"]


class ApproximationWarning(RuntimeWarning):
    """Emitted when an approximate likelihood cannot reach its requested
    accuracy (an ALE sample cap below the budget ``error_tol`` needs)."""


class ResamplerWarning(RuntimeWarning):
    """Emitted when the bounded validity-redraw loop of a resampler
    exhausted its budget and invalid proposals were replaced by their
    (valid) ancestors."""


class ResamplerError(RuntimeError):
    """Raised when a resampler cannot produce a valid particle set at
    all."""


class ZeroWeightWarning(RuntimeWarning):
    """Emitted when an observed datum annihilated (numerically) all particle
    weights and the updater's ``zero_weight_policy`` recovered by resetting."""


class ZeroWeightError(RuntimeError):
    """Raised when an observed datum annihilated all particle weights and the
    updater's ``zero_weight_policy`` is ``'error'``."""
