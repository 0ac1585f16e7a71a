"""Built-in example likelihood models (counterpart of
:mod:`qinfer_tpu.test_models`: ``SimplePrecessionModel``, ``CoinModel``,
and the Ramsey family of BASELINE config 2, ``MultiCosineModel`` and
``RamseyModel``). All are differentiable: the score is autograd of the
likelihood."""

from __future__ import annotations

import torch

from .abstract_model import (DifferentiableModel, FiniteOutcomeModel,
                             atleast_2d, n_expparams)

__all__ = ["SimplePrecessionModel", "CoinModel", "MultiCosineModel",
           "RamseyModel"]


class SimplePrecessionModel(DifferentiableModel, FiniteOutcomeModel):
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


class CoinModel(DifferentiableModel, FiniteOutcomeModel):
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


class MultiCosineModel(DifferentiableModel, FiniteOutcomeModel):
    """A mean of ``n_terms`` fringes: Pr(0 | ω₁..ω_k; t) = (1/k) Σⱼ
    cos²(ωⱼ t / 2), each ωⱼ ≥ ``min_freq``; ``canonicalize`` sorts the
    frequencies, which breaks the permutation symmetry."""

    def __init__(self, n_terms=2, min_freq=0.0):
        super().__init__()
        self.n_terms = int(n_terms)
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return self.n_terms

    @property
    def modelparam_names(self):
        return [f"omega_{i}" for i in range(self.n_terms)]

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        return torch.all(modelparams >= self.min_freq, dim=1)

    def canonicalize(self, modelparams):
        return torch.sort(atleast_2d(modelparams), dim=1).values

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        t = eps["t"]
        phases = modelparams[:, :, None] * t[None, None, :] / 2.0
        pr0 = torch.mean(torch.cos(phases) ** 2, dim=1)
        return self.pr0_to_likelihood_array(outcomes, pr0)


class RamseyModel(DifferentiableModel, FiniteOutcomeModel):
    """A Ramsey fringe with T2 decay as a nuisance parameter:
    Pr(0 | ω, Γ; t) = e^{−Γt} cos²(ω t / 2) + (1 − e^{−Γt}) / 2, with
    Γ = 1/T2; valid for ω ≥ ``min_freq`` and Γ ≥ 0."""

    def __init__(self, min_freq=0.0):
        super().__init__()
        self.min_freq = float(min_freq)

    @property
    def n_modelparams(self):
        return 2

    @property
    def modelparam_names(self):
        return ["omega", "Gamma"]

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        return (modelparams[:, 0] >= self.min_freq) & (modelparams[:, 1] >= 0)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        t = eps["t"]
        omega = modelparams[:, 0:1]
        gamma = modelparams[:, 1:2]
        visibility = torch.exp(-gamma * t[None, :])
        pr0 = (visibility * torch.cos(omega * t[None, :] / 2.0) ** 2
               + (1.0 - visibility) / 2.0)
        return self.pr0_to_likelihood_array(outcomes, pr0)
