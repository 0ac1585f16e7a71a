"""Built-in example likelihood models (counterpart of
:mod:`qinfer_tpu.test_models`: ``SimplePrecessionModel`` and
``CoinModel``)."""

from __future__ import annotations

import torch

from .abstract_model import FiniteOutcomeModel, atleast_2d, n_expparams

__all__ = ["SimplePrecessionModel", "CoinModel"]


class SimplePrecessionModel(FiniteOutcomeModel):
    """Single-frequency precession: Pr(0 | ω; t) = cos²(ω t / 2), with one
    model parameter ω ≥ ``min_freq`` and expparams ``[('t', float)]``."""

    def __init__(self, min_freq=0.0):
        super().__init__()
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["omega"]

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        return modelparams[:, 0] >= self.min_freq

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        t = eps["t"]  # (n_e,)
        omega = modelparams[:, 0]  # (n_m,)
        pr0 = torch.cos(omega[:, None] * t[None, :] / 2.0) ** 2
        return self.pr0_to_likelihood_array(outcomes, pr0)


class CoinModel(FiniteOutcomeModel):
    """The heads probability p of a coin: Pr(0 | p) = p, valid for
    0 ≤ p ≤ 1. Experiments carry only a dummy ``exp_num`` field, so that
    a batch of them has a leading axis."""

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["p"]

    @property
    def expparams_dtype(self):
        return [("exp_num", "int32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        p = atleast_2d(modelparams)[:, 0]
        return (p >= 0) & (p <= 1)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        p = modelparams[:, 0]
        pr0 = p[:, None].expand(p.shape[0], n_expparams(eps))
        return self.pr0_to_likelihood_array(outcomes, pr0)
