"""Numeric defaults shared by the whole port.

Counterpart of :mod:`qinfer_tpu.config`: particles, weights and
likelihoods are ``float32``; outcomes are ``int32``; ``EPS`` is the floor
used when clipping probabilities and weights before a log or a division.
"""

import torch

__all__ = ["default_dtype", "default_int_dtype", "EPS"]

default_dtype = torch.float32
default_int_dtype = torch.int32

#: smallest safe positive float for clipping probabilities / weights
EPS = 1e-35
