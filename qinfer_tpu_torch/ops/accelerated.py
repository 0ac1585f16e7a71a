"""Kernel-backed precession model (counterpart of
:mod:`qinfer_tpu.ops.accelerated`)."""

from __future__ import annotations

import torch

from ..abstract_model import atleast_2d
from ..test_models import SimplePrecessionModel
from .precession import fused_precession_update, precession_pr0

__all__ = ["AcceleratedPrecessionModel"]


class AcceleratedPrecessionModel(SimplePrecessionModel):
    """:class:`~qinfer_tpu_torch.test_models.SimplePrecessionModel` whose
    likelihood table comes from kernel K2 and whose reweighting step is
    kernel K1. float32 only. The kernels take any particle count.

    The score differentiates the plain likelihood: K2 has no autograd or
    vmap rule. The JAX package's score reaches the plain likelihood too,
    since each vmapped particle falls below its kernel's row tile."""

    def __init__(self, precision="float", min_freq=0.0):
        super().__init__(min_freq=min_freq)
        if precision not in ("float", "single", "float32"):
            raise ValueError("the kernels are float32; use "
                             "SimplePrecessionModel for float64")
        self.precision = "float"

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        pr0 = precession_pr0(modelparams[:, 0], eps["t"])  # (n, n_e)
        return self.pr0_to_likelihood_array(outcomes, pr0)

    _score_likelihood = SimplePrecessionModel.likelihood

    def fused_reweight(self, weights, locations, outcome, expparams):
        """Engine hook (``smc._reweight``): the whole reweighting step as one
        pass of kernel K1. Returns ``(unnormalized h, linear norm Σh)``;
        the engine normalizes and takes the log for the evidence record."""
        eps = self.canonicalize_expparams(expparams, locations.device)
        outcome = torch.as_tensor(outcome, device=locations.device)
        hyp, norm, _, _ = fused_precession_update(
            locations[:, 0], weights, eps["t"][:1], outcome.reshape(-1)[:1],
            normalize=False)
        return hyp, norm
