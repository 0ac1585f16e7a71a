"""Model and simulator abstractions (counterpart of
:mod:`qinfer_tpu.abstract_model`: ``Simulatable`` → ``Model`` →
``FiniteOutcomeModel``, and ``DifferentiableModel`` with ``ScoreMixin``).

* ``likelihood(outcomes, modelparams, expparams)`` keeps the reference's
  ``(n_outcomes, n_models, n_expparams)`` shape contract.
* Experiment parameters are a ``dict`` mapping field name → tensor with
  leading axis ``n_expparams``; :meth:`Simulatable.canonicalize_expparams`
  coerces dicts, NumPy structured arrays and bare values to that form on a
  given device.
* Every stochastic call takes an explicit :class:`torch.Generator`, whose
  device is the device the draw lands on.
* A time-dependent model overrides ``update_timestep``, which the engine
  then runs after every reweighting (``is_time_dependent``).
* A model whose likelihood is a Monte-Carlo estimate sets
  ``wants_likelihood_key = True``; the engine then passes
  ``generator=`` (a :class:`torch.Generator`) to every ``likelihood``
  call it makes, so the noise is fresh on every call.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EPS
from .domains import IntegerDomain

__all__ = [
    "keyed_kwargs",
    "Simulatable",
    "Model",
    "FiniteOutcomeModel",
    "DifferentiableModel",
    "ScoreMixin",
    "expparams_to_dict",
    "dict_to_expparams",
    "concat_expparams",
    "n_expparams",
    "expparams_at",
    "atleast_2d",
]


def keyed_kwargs(model, generator):
    """The keyword arguments of an engine likelihood call: ``generator=``
    for a model whose likelihood draws Monte-Carlo noise
    (``wants_likelihood_key``) when a generator is given, else none."""
    if generator is not None and getattr(model, "wants_likelihood_key",
                                         False):
        return {"generator": generator}
    return {}


def atleast_2d(x):
    """``x`` as a tensor with at least two dimensions (a row for 0-d/1-d)."""
    x = torch.as_tensor(x)
    while x.ndim < 2:
        x = x.unsqueeze(0)
    return x


def _field(value, device=None):
    """One expparams field as an at-least-1-d tensor. Doubles and longs
    become float32 and int32, as in the JAX package with x64 off."""
    t = torch.as_tensor(value, device=device)
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t.reshape(1) if t.ndim == 0 else t


def expparams_to_dict(eps, expparams_dtype=None, device=None):
    """Normalize experiment parameters to a dict of tensors with leading
    axis ``n_expparams``. Accepts a dict, a NumPy structured array, or —
    for single-field models — a bare scalar/array."""
    if isinstance(eps, dict):
        return {k: _field(v, device) for k, v in eps.items()}
    arr = np.asarray(eps)
    if arr.dtype.names:  # structured array
        return {name: _field(arr[name], device) for name in arr.dtype.names}
    if expparams_dtype is not None:
        names = [f[0] for f in expparams_dtype]
        if len(names) == 1:
            return {names[0]: _field(arr, device)}
    raise ValueError(
        "cannot coerce expparams %r without a single-field dtype" % (eps,))


def n_expparams(eps_dict):
    """Number of experiments in an expparams dict (leading axis)."""
    for v in eps_dict.values():
        return v.shape[0]
    return 0


def expparams_at(eps_dict, idx):
    """Select experiment ``idx`` keeping the leading axis (length 1)."""
    return {k: v[idx:idx + 1] for k, v in eps_dict.items()}


def dict_to_expparams(eps_dict, expparams_dtype):
    """An expparams dict as a host NumPy structured array of
    ``expparams_dtype`` (interop with reference-style code)."""
    n = n_expparams(eps_dict)
    out = np.empty((n,), dtype=np.dtype(expparams_dtype))
    for name in out.dtype.names:
        v = eps_dict[name]
        out[name] = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return out


def concat_expparams(eps_list):
    """Concatenate expparams dicts along the experiment axis."""
    return {k: torch.cat([e[k] for e in eps_list]) for k in eps_list[0]}


class Simulatable:
    """A parametric system that can be simulated, but need not expose an
    analytic likelihood (``n_modelparams``, ``expparams_dtype``,
    ``n_outcomes``, ``domain``, ``are_models_valid``, ``canonicalize``,
    ``simulate_experiment``, ``sim_count``/``call_count``)."""

    def __init__(self):
        self._sim_count = 0
        self._call_count = 0

    #: dimensions of ONE outcome: 0 for scalar outcomes, 1 for vectors
    #: (``MultinomialModel``'s count vectors)
    outcome_ndim = 0

    @property
    def n_modelparams(self):
        raise NotImplementedError

    @property
    def modelparam_names(self):
        return [f"x_{i}" for i in range(self.n_modelparams)]

    @property
    def expparams_dtype(self):
        """Reference-style dtype: a list of (name, dtype[, shape])."""
        raise NotImplementedError

    @property
    def is_n_outcomes_constant(self):
        return True

    def n_outcomes(self, expparams=None):
        raise NotImplementedError

    def domain(self, expparams=None):
        raise NotImplementedError

    def are_models_valid(self, modelparams):
        """(n_models,) boolean validity mask."""
        raise NotImplementedError

    def canonicalize(self, modelparams):
        """Map model parameters to canonical form (default: identity)."""
        return modelparams

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Draw outcomes for each (model, experiment) pair:
        ``(repeat, n_models, n_expparams)``, squeezed when ``repeat == 1``."""
        raise NotImplementedError

    @property
    def is_time_dependent(self):
        """True when the model evolves its parameters between experiments
        (the engine then runs :meth:`update_timestep` every step): whether
        the class overrides :meth:`update_timestep`."""
        return type(self).update_timestep is not Simulatable.update_timestep

    def update_timestep(self, generator, modelparams, expparams):
        """Evolve model parameters after an experiment:
        ``(n_models, n_modelparams, n_expparams)``; the identity by
        default."""
        modelparams = atleast_2d(modelparams)
        n_e = n_expparams(self.canonicalize_expparams(
            expparams, modelparams.device))
        return modelparams[:, :, None].expand(-1, -1, n_e)

    def _bump(self, name, k=1):
        setattr(self, name, getattr(self, name, 0) + k)

    @property
    def sim_count(self):
        return self._sim_count

    @property
    def call_count(self):
        return self._call_count

    @property
    def allow_identical_outcomes(self):
        """Whether the model may report two identical outcomes for
        distinct labels (no by default, as in the reference package)."""
        return False

    def clear_cache(self):
        """Drop cached computations (a no-op hook, as in the reference
        package)."""

    def reset_counters(self):
        self._sim_count = 0
        self._call_count = 0

    def experiment_cost(self, expparams):
        """Cost of each experiment: (n_expparams,), one each by default
        (override for time-weighted designs)."""
        eps = self.canonicalize_expparams(expparams)
        dev = next(iter(eps.values())).device if eps else None
        return torch.ones((n_expparams(eps),), device=dev)

    def canonicalize_expparams(self, expparams, device=None):
        """Coerce expparams (dict / structured array / scalar) to a dict of
        tensors on ``device`` (left where they are when None). An EMPTY dict
        means one default experiment whose fields are zeros."""
        if isinstance(expparams, dict) and not expparams:
            out = {}
            for field in self.expparams_dtype:
                name, dtype = field[0], field[1]
                shape = ((1,) + tuple(np.atleast_1d(field[2]).tolist())
                         if len(field) > 2 else (1,))
                out[name] = _field(np.zeros(shape, dtype=dtype), device)
            return out
        return expparams_to_dict(expparams, self.expparams_dtype, device)


class Model(Simulatable):
    """A simulatable system with an analytic likelihood of shape
    ``(n_outcomes, n_models, n_expparams)``, the quadratic-loss scale ``Q``
    and ``distance``."""

    def likelihood(self, outcomes, modelparams, expparams):
        raise NotImplementedError

    def log_likelihood(self, outcomes, modelparams, expparams):
        """log of :meth:`likelihood`, same shape contract. Models whose
        likelihoods underflow float32 override this with a stable form; the
        engine then uses its max-shifted weight update."""
        return torch.log(torch.clamp_min(
            self.likelihood(outcomes, modelparams, expparams), EPS))

    @property
    def has_log_likelihood(self):
        """True when a subclass overrides :meth:`log_likelihood` (the base
        clip-and-log default does not count)."""
        for klass in type(self).__mro__:
            if "log_likelihood" in vars(klass):
                return klass is not Model
        return False

    def outcome_mask(self, expparams):
        """(n_outcomes, n_expparams) boolean mask of the outcome grid's
        real slots for each experiment: all true unless a model pads its
        grid (``BinomialModel`` with per-experiment ``n_meas``)."""
        eps = self.canonicalize_expparams(expparams)
        dev = next(iter(eps.values())).device if eps else None
        return torch.ones((self.n_outcomes(eps), n_expparams(eps)),
                          dtype=torch.bool, device=dev)

    @property
    def Q(self):
        """Positive weights of the quadratic loss (ones by default)."""
        return torch.ones((self.n_modelparams,))

    def distance(self, a, b):
        """Q-weighted distance between two batches of model parameters."""
        a = atleast_2d(a)
        b = atleast_2d(b)
        d = a - b
        q = self.Q.to(device=d.device, dtype=d.dtype, non_blocking=True)
        return torch.sqrt(torch.sum(q * d * d, dim=-1))


class FiniteOutcomeModel(Model):
    """A model whose outcomes form a finite set: generic simulation by
    sampling the categorical likelihood, and the static
    :meth:`pr0_to_likelihood_array`."""

    def domain(self, expparams=None):
        return IntegerDomain(0, self.n_outcomes(expparams) - 1)

    def outcomes(self, expparams=None, device=None):
        """Dense outcome values ``0..n_outcomes-1``."""
        return torch.arange(self.n_outcomes(expparams), dtype=torch.int32,
                            device=device)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        self._bump("_sim_count",
                   int(repeat) * modelparams.shape[0] * n_expparams(eps))
        outcomes = self.outcomes(eps, device=modelparams.device)
        L = self.likelihood(outcomes, modelparams, eps)
        # categorical over the outcome axis by inverse CDF on one uniform
        # per draw; probabilities ∝ clip(L, EPS) as in the JAX package
        cdf = torch.cumsum(torch.clamp_min(L, EPS).movedim(0, -1), dim=-1)
        u = torch.rand((int(repeat),) + cdf.shape[:-1] + (1,),
                       generator=generator, device=cdf.device,
                       dtype=cdf.dtype)
        idx = torch.sum(cdf[None] <= u * cdf[..., -1:], dim=-1)
        sampled = outcomes[idx.clamp_max(outcomes.shape[0] - 1)]
        if repeat == 1:
            sampled = sampled[0]
        return sampled

    @staticmethod
    def pr0_to_likelihood_array(outcomes, pr0):
        """Stack a two-outcome Pr(0) table into the full likelihood array:
        outcome 0 ↦ pr0, anything else ↦ 1 − pr0.

        :param outcomes: (n_outcomes,) outcome labels.
        :param pr0: (n_models, n_expparams) probability of outcome 0.
        :return: (n_outcomes, n_models, n_expparams).
        """
        outcomes = torch.as_tensor(outcomes, device=pr0.device)
        o = outcomes.reshape((-1,) + (1,) * pr0.ndim)
        return torch.where(o == 0, pr0[None], 1.0 - pr0[None])


class DifferentiableModel(Model):
    """A model with the score ∂ log L / ∂θ and the Fisher information.

    :meth:`score` differentiates the log of :meth:`_score_likelihood` (the
    likelihood by default) by per-particle reverse-mode autograd,
    ``torch.func.vmap(torch.func.jacrev(...))``: each particle's Jacobian
    is (n_outcomes, n_expparams, d), so the work and memory are O(n·d),
    never the O(n²) of a whole-batch Jacobian.
    """

    def _score_likelihood(self, outcomes, modelparams, expparams):
        """The likelihood that :meth:`score` differentiates: a model whose
        likelihood runs a kernel without an autograd rule names its plain
        twin here."""
        return self.likelihood(outcomes, modelparams, expparams)

    def score(self, outcomes, modelparams, expparams, return_L=False):
        """∂ log L(outcome | θ, e) / ∂θ: ``(n_modelparams, n_outcomes,
        n_models, n_expparams)``; with ``return_L`` also the likelihood
        ``(n_outcomes, n_models, n_expparams)``."""
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        outcomes = torch.as_tensor(outcomes, device=modelparams.device)
        outcomes = outcomes.reshape(-1) if outcomes.ndim == 0 else outcomes

        def log_L_single(x):
            # one particle (d,) -> (n_outcomes, n_expparams)
            L = self._score_likelihood(outcomes, x[None, :], eps)
            return torch.log(torch.clamp_min(L[:, 0, :], EPS))

        jac = torch.func.vmap(torch.func.jacrev(log_L_single))(modelparams)
        # (n_m, n_out, n_e, d) -> (d, n_out, n_m, n_e)
        q = jac.permute(3, 1, 0, 2)
        if return_L:
            return q, self.likelihood(outcomes, modelparams, eps)
        return q

    def fisher_information(self, modelparams, expparams):
        """E_outcomes[score scoreᵀ] for each (model, experiment):
        ``(d, d, n_models, n_expparams)``."""
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        outcomes_fn = getattr(self, "outcomes", None)
        if outcomes_fn is None:
            raise NotImplementedError(
                "fisher_information requires a finite outcome set")
        scores, L = self.score(outcomes_fn(eps, device=modelparams.device),
                               modelparams, eps, return_L=True)
        return torch.einsum("iomE,jomE,omE->ijmE", scores, scores, L)


class ScoreMixin:
    """The score by central finite differences (step ``_h`` = 1e-5 on each
    parameter), for likelihoods that autograd cannot differentiate. Put it
    before :class:`DifferentiableModel` in the bases."""

    _h = 1e-5

    def score(self, outcomes, modelparams, expparams, return_L=False):
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        outcomes = torch.as_tensor(outcomes, device=modelparams.device)
        outcomes = outcomes.reshape(-1) if outcomes.ndim == 0 else outcomes
        d = self.n_modelparams
        h = self._h

        def log_L(mps):
            return torch.log(torch.clamp_min(
                self.likelihood(outcomes, mps, eps), EPS))

        cols = []
        for i in range(d):
            dx = torch.zeros((1, d), dtype=modelparams.dtype,
                             device=modelparams.device)
            dx[0, i] = h
            cols.append((log_L(modelparams + dx) - log_L(modelparams - dx))
                        / (2 * h))
        q = torch.stack(cols, dim=0)
        if return_L:
            return q, self.likelihood(outcomes, modelparams, eps)
        return q
