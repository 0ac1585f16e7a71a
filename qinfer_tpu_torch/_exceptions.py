"""Warnings and exceptions of the port (counterparts of
:mod:`qinfer_tpu._exceptions` used on the SMC main path)."""

__all__ = ["ResamplerWarning", "ZeroWeightWarning", "ZeroWeightError"]


class ResamplerWarning(RuntimeWarning):
    """Emitted when the bounded validity-redraw loop of a resampler
    exhausted its budget and invalid proposals were replaced by their
    (valid) ancestors."""


class ZeroWeightWarning(RuntimeWarning):
    """Emitted when an observed datum annihilated (numerically) all particle
    weights and the updater's ``zero_weight_policy`` recovered by resetting."""


class ZeroWeightError(RuntimeError):
    """Raised when an observed datum annihilated all particle weights and the
    updater's ``zero_weight_policy`` is ``'error'``."""
