"""Numeric defaults shared by the whole port.

Counterpart of :mod:`qinfer_tpu.config`: particles, weights and
likelihoods are ``float32``; outcomes are ``int32``; ``EPS`` is the floor
used when clipping probabilities and weights before a log or a division.
The port's entry points run on the card (``DEFAULT_DEVICE``) unless the
caller asks for the CPU; :func:`resolve_device` refuses a CUDA device on a
machine without one instead of running on the CPU.
"""

import torch

__all__ = ["default_dtype", "default_int_dtype", "set_default_dtype", "EPS",
           "DEFAULT_DEVICE", "resolve_device"]

default_dtype = torch.float32
default_int_dtype = torch.int32


def set_default_dtype(dtype):
    """Set the package-wide default floating dtype (``default_dtype``)."""
    global default_dtype
    default_dtype = dtype


#: smallest safe positive float for clipping probabilities / weights
EPS = 1e-35

#: where the entry points (``SMCUpdater``, ``perf_test``) run by default
DEFAULT_DEVICE = "cuda"


def resolve_device(device):
    """``torch.device(device)``, raising ``RuntimeError`` for a CUDA device
    when this machine has none: a run never drops to the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return device
