"""Built-in example likelihood models (counterpart of
:mod:`qinfer_tpu.test_models`: ``SimplePrecessionModel``,
``SimpleInversionModel``, ``CoinModel``, ``NoisyCoinModel``,
``NDieModel``, and the Ramsey family of BASELINE config 2,
``MultiCosineModel`` and ``RamseyModel``). All but ``NDieModel`` are
differentiable: the score is autograd of the likelihood."""

from __future__ import annotations

import torch

from .abstract_model import (DifferentiableModel, FiniteOutcomeModel,
                             atleast_2d, building_design_table, n_expparams)
from .domains import IntegerDomain

__all__ = ["SimplePrecessionModel", "SimpleInversionModel", "CoinModel",
           "NoisyCoinModel", "NDieModel", "MultiCosineModel",
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
        if building_design_table():
            # the phase in float64, where the product of two float32
            # values is exact: in float32 it is off by up to half an ulp of
            # ω·t/2 (4e-3 rad at t ~ 1e5, where PGH's candidates go once
            # 10⁷ particles narrow the posterior), which the information
            # gain's entropy terms near Pr(0) = 0 or 1 read as a gap of
            # 5e-3 of the best score
            phase = omega.double()[:, None] * (0.5 * t.double())[None, :]
            pr0 = torch.cos(phase).to(torch.promote_types(
                omega.dtype, t.dtype)) ** 2
        else:
            pr0 = torch.cos(omega[:, None] * t[None, :] / 2.0) ** 2
        return self.pr0_to_likelihood_array(outcomes, pr0)


class SimpleInversionModel(DifferentiableModel, FiniteOutcomeModel):
    """Precession against a controllable inversion frequency:
    Pr(0 | ω; t, ω_inv) = cos²((ω − ω_inv) t / 2), expparams
    ``[('t', float), ('w_', float)]`` (``qinfer_tpu/test_models.py:78``)."""

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
        return [("t", "float32"), ("w_", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        return atleast_2d(modelparams)[:, 0] >= self.min_freq

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        omega = modelparams[:, 0]
        pr0 = torch.cos((omega[:, None] - eps["w_"][None, :])
                        * eps["t"][None, :] / 2.0) ** 2
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


class NoisyCoinModel(DifferentiableModel, FiniteOutcomeModel):
    """A coin seen through an asymmetric noisy channel:
    Pr(0 | p; α, β) = α p + β (1 − p), expparams ``[('alpha', float),
    ('beta', float)]`` (``qinfer_tpu/test_models.py:161``)."""

    @property
    def n_modelparams(self):
        return 1

    @property
    def modelparam_names(self):
        return ["p"]

    @property
    def expparams_dtype(self):
        return [("alpha", "float32"), ("beta", "float32")]

    def n_outcomes(self, expparams=None):
        return 2

    def are_models_valid(self, modelparams):
        p = atleast_2d(modelparams)[:, 0]
        return (p >= 0) & (p <= 1)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        p = modelparams[:, 0:1]
        pr0 = eps["alpha"][None, :] * p + eps["beta"][None, :] * (1 - p)
        return self.pr0_to_likelihood_array(outcomes, pr0)


class NDieModel(FiniteOutcomeModel):
    """An ``n``-sided die whose face probabilities are the model
    parameters (``qinfer_tpu/test_models.py:203``). Valid parameters are
    non-negative and sum to 1 within ``threshold``; :meth:`canonicalize`
    clips at 0 and renormalizes."""

    def __init__(self, n=6, threshold=1e-5):
        super().__init__()
        self.n = int(n)
        self.threshold = float(threshold)

    @property
    def n_modelparams(self):
        return self.n

    @property
    def modelparam_names(self):
        return [f"p_{i}" for i in range(self.n)]

    @property
    def expparams_dtype(self):
        return [("exp_num", "int32")]

    def n_outcomes(self, expparams=None):
        return self.n

    def domain(self, expparams=None):
        return IntegerDomain(0, self.n - 1)

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        nonneg = torch.all(modelparams >= 0, dim=1)
        normed = (torch.abs(torch.sum(modelparams, dim=1) - 1.0)
                  < self.threshold)
        return nonneg & normed

    def canonicalize(self, modelparams):
        clipped = torch.clamp_min(atleast_2d(modelparams), 0.0)
        total = torch.sum(clipped, dim=1, keepdim=True)
        return clipped / torch.where(total == 0, 1.0, total)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        outcomes = torch.as_tensor(outcomes, device=modelparams.device)
        probs = modelparams.T[outcomes.reshape(-1).long()]  # (n_out, n_m)
        return probs[:, :, None].expand(-1, -1, n_expparams(eps))


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
