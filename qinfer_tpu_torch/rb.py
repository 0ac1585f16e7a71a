"""Randomized benchmarking (counterpart of :mod:`qinfer_tpu.rb`):
zeroth-order ``RandomizedBenchmarkingModel``, plain and interleaved, and
the conversions between the decay parameter p and the average gate
fidelity F."""

from __future__ import annotations

import torch

from .abstract_model import (DifferentiableModel, FiniteOutcomeModel,
                             atleast_2d)

__all__ = ["RandomizedBenchmarkingModel", "p_to_F", "F_to_p"]


def p_to_F(p, d=2):
    """Average gate fidelity of a decay parameter: F = (d−1)·p/d + 1/d."""
    return (d - 1.0) * p / d + 1.0 / d


def F_to_p(F, d=2):
    """Inverse of :func:`p_to_F`."""
    return (d * F - 1.0) / (d - 1.0)


class RandomizedBenchmarkingModel(DifferentiableModel, FiniteOutcomeModel):
    """Zeroth-order randomized benchmarking: the survival probability of a
    length-m sequence is Pr(0) = A·p^m + B, clipped to [0, 1].

    Model parameters ``(p, A, B)``; interleaved ``(p̃, p_ref, A, B)``, where
    an experiment's ``reference`` field (1: the reference sequence) picks
    p_ref and 0 picks p̃. Experiments ``[('m', int32)]`` (+ ``reference``).
    Valid: 0 ≤ p ≤ 1 (each p), A, B ≥ 0 and A + B ≤ 1.
    """

    def __init__(self, interleaved=False, order=0):
        super().__init__()
        if order != 0:
            raise NotImplementedError("only 0th-order RB is supported")
        self.interleaved = bool(interleaved)
        self.order = int(order)

    @property
    def n_modelparams(self):
        return 4 if self.interleaved else 3

    @property
    def modelparam_names(self):
        if self.interleaved:
            return ["p_tilde", "p_ref", "A", "B"]
        return ["p", "A", "B"]

    @property
    def expparams_dtype(self):
        if self.interleaved:
            return [("m", "int32"), ("reference", "int32")]
        return [("m", "int32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        n_p = 2 if self.interleaved else 1
        p = modelparams[:, :n_p]
        A, B = modelparams[:, -2], modelparams[:, -1]
        p_ok = torch.all((p >= 0) & (p <= 1), dim=1)
        return p_ok & (A >= 0) & (B >= 0) & (A + B <= 1)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        m = eps["m"].to(modelparams.dtype)
        if self.interleaved:
            ref = eps["reference"].to(torch.bool)
            p = torch.where(ref[None, :], modelparams[:, 1:2],
                            modelparams[:, 0:1])
        else:
            p = modelparams[:, 0:1]
        A = modelparams[:, -2:-1]
        B = modelparams[:, -1:]
        pr0 = torch.clamp(A * p ** m[None, :] + B, 0.0, 1.0)
        return self.pr0_to_likelihood_array(outcomes, pr0)
