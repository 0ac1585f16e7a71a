"""Model decorators (counterpart of :mod:`qinfer_tpu.derived_models`:
``DerivedModel``, ``PoisonedModel``, ``BinomialModel``,
``MultinomialModel``, ``MLEModel``, ``RandomWalkModel``,
``GaussianRandomWalkModel`` and ``ReferencedPoissonModel``).

A decorator delegates the model contract to the model it wraps, one named
method at a time; nothing is forwarded by attribute lookup. The engine's
hooks are looked up on the model's type (``smc._reweight``), so a wrapper
that transforms the likelihood never inherits the wrapped model's fused
reweight: ``BinomialModel(AcceleratedPrecessionModel())`` takes the
log-binomial path, not kernel K1's single-shot reweight.
"""

from __future__ import annotations

import math
from math import comb

import numpy as np
import torch

from .abstract_model import Model, atleast_2d, n_expparams, per_particle
from .config import EPS
from .domains import IntegerDomain, MultinomialDomain, _compositions
from .utils import log_binomial_pdf, multinomial_pdf

__all__ = ["DerivedModel", "PoisonedModel", "BinomialModel",
           "MultinomialModel", "MLEModel", "RandomWalkModel",
           "GaussianRandomWalkModel", "ReferencedPoissonModel"]


class DerivedModel(Model):
    """Base of the models that decorate an underlying model, delegating
    the whole :class:`~qinfer_tpu_torch.abstract_model.Model` contract by
    default (``underlying_model``, ``base_model``, ``model_chain``)."""

    def __init__(self, underlying_model):
        super().__init__()
        self.underlying_model = underlying_model

    @property
    def base_model(self):
        """The innermost model that is not a decorator."""
        m = self.underlying_model
        while isinstance(m, DerivedModel):
            m = m.underlying_model
        return m

    @property
    def model_chain(self):
        """The models from this decorator down to the base model."""
        chain = [self]
        m = self.underlying_model
        while isinstance(m, DerivedModel):
            chain.append(m)
            m = m.underlying_model
        chain.append(m)
        return tuple(chain)

    # -- delegation --------------------------------------------------------

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams

    @property
    def modelparam_names(self):
        return self.underlying_model.modelparam_names

    @property
    def expparams_dtype(self):
        return self.underlying_model.expparams_dtype

    @property
    def is_n_outcomes_constant(self):
        return self.underlying_model.is_n_outcomes_constant

    @property
    def Q(self):
        return self.underlying_model.Q

    def n_outcomes(self, expparams=None):
        return self.underlying_model.n_outcomes(expparams)

    def domain(self, expparams=None):
        return self.underlying_model.domain(expparams)

    def outcomes(self, expparams=None, device=None):
        return self.underlying_model.outcomes(expparams, device=device)

    def outcome_mask(self, expparams):
        return self.underlying_model.outcome_mask(expparams)

    @property
    def outcome_ndim(self):
        return self.underlying_model.outcome_ndim

    def experiment_cost(self, expparams):
        return self.underlying_model.experiment_cost(expparams)

    def are_models_valid(self, modelparams):
        return self.underlying_model.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.underlying_model.canonicalize(modelparams)

    def update_timestep(self, generator, modelparams, expparams):
        return self.underlying_model.update_timestep(
            generator, modelparams, expparams)

    @property
    def is_time_dependent(self):
        """A decorator is time-dependent exactly when the model below is
        (overriding :meth:`update_timestep` to delegate does not count)."""
        return self.underlying_model.is_time_dependent

    def likelihood(self, outcomes, modelparams, expparams, **kwargs):
        return self.underlying_model.likelihood(outcomes, modelparams,
                                                expparams, **kwargs)

    def log_likelihood(self, outcomes, modelparams, expparams, **kwargs):
        """Pure delegation; advertised (:attr:`has_log_likelihood`) only
        when this decorator does not transform the likelihood and the
        model below has a stable log form."""
        return self.underlying_model.log_likelihood(outcomes, modelparams,
                                                    expparams, **kwargs)

    def _transforms_likelihood(self):
        """Whether a class below :class:`DerivedModel` defines
        ``likelihood``: the model below's engine hooks then do not carry
        over."""
        for klass in type(self).__mro__:
            if klass is DerivedModel:
                return False
            if "likelihood" in vars(klass):
                return True
        return False

    @property
    def wants_likelihood_key(self):
        """Whether the engine passes a ``generator`` to the likelihood: the
        model below's answer for a pure delegator, False for a decorator
        that transforms the likelihood (its signature takes no
        generator)."""
        if self._transforms_likelihood():
            return False
        return bool(getattr(self.underlying_model, "wants_likelihood_key",
                            False))

    @property
    def has_log_likelihood(self):
        """Whether the engine may take the max-shifted log path: a
        decorator that defines its own ``log_likelihood`` says yes; one
        that transforms ``likelihood`` without one says no; a pure
        delegator asks the model below."""
        for klass in type(self).__mro__:
            if klass is DerivedModel:
                break
            if "log_likelihood" in vars(klass):
                return True
            if "likelihood" in vars(klass):
                return False
        return bool(getattr(self.underlying_model, "has_log_likelihood",
                            False))

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        return self.underlying_model.simulate_experiment(
            generator, modelparams, expparams, repeat=repeat)


def _device_generator(owner, device, seed):
    """``owner``'s own generator on ``device``, seeded with ``seed`` at
    first use and advancing from call to call: the stream of a keyed
    likelihood called without one."""
    gens = owner.__dict__.setdefault("_generators", {})
    device = torch.device(device)
    if device not in gens:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        gens[device] = g
    return gens[device]


class PoisonedModel(DerivedModel):
    """The underlying likelihood corrupted by Gaussian noise, clipped to
    [0, 1] (``qinfer_tpu/derived_models.py:188``): a fault-injection tool.
    In tol mode the noise's standard deviation is ``tol``; in ALE mode it
    is the hedged binomial standard error that an
    :class:`~qinfer_tpu_torch.ale.ALEApproximateModel` of ``n_samples``
    simulations and ``hedge`` would incur at each likelihood value.

    The engine passes a fresh ``generator`` to every call
    (``wants_likelihood_key``); a direct call without one draws from the
    model's own generator on the likelihood's device, seeded with
    ``seed`` at first use.
    """

    wants_likelihood_key = True

    def __init__(self, underlying_model, tol=None, n_samples=None,
                 hedge=None, seed=0):
        super().__init__(underlying_model)
        if tol is None and n_samples is None:
            raise ValueError("specify tol (constant mode) or n_samples "
                             "(ALE mode)")
        self.tol = float(tol) if tol is not None else None
        self.n_samples = int(n_samples) if n_samples is not None else None
        self.hedge = float(hedge) if hedge is not None else 0.0
        self.seed = int(seed)

    def noise_sigma(self, L):
        """The noise's standard deviation at likelihood values ``L``."""
        if self.tol is not None:
            return self.tol
        n, h = self.n_samples, self.hedge
        p_hat = (L * n + h) / (n + 2 * h)
        return torch.sqrt(p_hat * (1 - p_hat) / (n + 2 * h + 1))

    def likelihood(self, outcomes, modelparams, expparams, generator=None):
        L = self.underlying_model.likelihood(outcomes, modelparams,
                                             expparams)
        if generator is None:
            generator = _device_generator(self, L.device, self.seed)
        noise = per_particle(generator, lambda g, block: torch.randn(
            block.shape, generator=g, device=block.device,
            dtype=block.dtype), L, dim=1) * self.noise_sigma(L)
        return torch.clamp(L + noise, 0.0, 1.0)


class BinomialModel(DerivedModel):
    """Lift a two-outcome model to repeated measurements: expparams gain an
    ``n_meas`` field and an outcome is the count of underlying outcome 0
    among ``n_meas`` shots; the likelihood is the binomial pmf of that
    count at the underlying Pr(0).

    :param int n_meas_max: upper bound on ``n_meas``: the outcome grid is
        ``0..n_meas_max`` and simulation draws ``n_meas_max`` uniforms per
        (model, experiment), masked by ``n_meas``. Updates take any count.
    """

    def __init__(self, underlying_model, n_meas_max=128):
        if underlying_model.n_outcomes(None) != 2:
            raise ValueError("BinomialModel requires a two-outcome model")
        super().__init__(underlying_model)
        self.n_meas_max = int(n_meas_max)

    outcome_ndim = 0

    @property
    def decorated_model(self):
        return self.underlying_model

    @property
    def expparams_dtype(self):
        return list(self.underlying_model.expparams_dtype) + [
            ("n_meas", "int32")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        return self.n_meas_max + 1

    def domain(self, expparams=None):
        if expparams is None:
            return IntegerDomain(0, self.n_meas_max)
        n_meas = self.canonicalize_expparams(expparams)["n_meas"]
        return [IntegerDomain(0, int(m)) for m in n_meas.tolist()]

    def outcomes(self, expparams=None, device=None):
        return torch.arange(self.n_meas_max + 1, dtype=torch.int32,
                            device=device)

    def outcome_mask(self, expparams):
        """(n_meas_max + 1, n_expparams): which counts each experiment can
        give."""
        n_meas = self.canonicalize_expparams(expparams)["n_meas"]
        grid = torch.arange(self.n_meas_max + 1, device=n_meas.device)
        return grid[:, None] <= n_meas[None, :]

    def _pr0(self, modelparams, eps):
        """Underlying Pr(outcome 0): (n_models, n_expparams)."""
        two_eps = {k: v for k, v in eps.items() if k != "n_meas"}
        zero = torch.zeros((1,), dtype=torch.int32,
                           device=modelparams.device)
        return self.underlying_model.likelihood(zero, modelparams,
                                                two_eps)[0]

    def likelihood(self, outcomes, modelparams, expparams):
        return torch.exp(self.log_likelihood(outcomes, modelparams,
                                             expparams))

    def log_likelihood(self, outcomes, modelparams, expparams):
        """The log-binomial in closed form, so the engine's max-shifted
        update survives counts whose linear pmf underflows float32.
        Counts above an experiment's ``n_meas`` are impossible (−inf)."""
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        pr0 = self._pr0(modelparams, eps)  # (n_m, n_e)
        n_meas = eps["n_meas"].to(pr0.dtype)
        outcomes = torch.as_tensor(outcomes, device=pr0.device).reshape(
            -1).to(pr0.dtype)
        # (n_out, n_m, n_e); success := underlying outcome 0
        logp = log_binomial_pdf(n_meas[None, None, :],
                                outcomes[:, None, None], pr0[None, :, :])
        valid = outcomes[:, None, None] <= n_meas[None, None, :]
        return torch.where(valid, logp, -torch.inf)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Counts ``(repeat, n_models, n_expparams)`` (squeezed when
        ``repeat == 1``), int32: ``n_meas_max`` uniforms per (model,
        experiment) from ``generator``, the first ``n_meas`` of them
        counted."""
        self._bump("_sim_count", int(repeat))
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        pr0 = self._pr0(modelparams, eps)
        n_meas = eps["n_meas"]
        u = torch.rand((int(repeat),) + tuple(pr0.shape)
                       + (self.n_meas_max,), generator=generator,
                       device=pr0.device, dtype=pr0.dtype)
        trial = torch.arange(self.n_meas_max, device=pr0.device)
        active = trial[None, None, None, :] < n_meas[None, None, :, None]
        out = torch.sum((u < pr0[None, :, :, None]) & active,
                        dim=-1).to(torch.int32)
        return out[0] if repeat == 1 else out

    def update_timestep(self, generator, modelparams, expparams):
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        two_eps = {k: v for k, v in eps.items() if k != "n_meas"}
        return self.underlying_model.update_timestep(generator, modelparams,
                                                     two_eps)


class MultinomialModel(DerivedModel):
    """Lift a k-outcome model to repeated measurements whose outcome is a
    count VECTOR over a :class:`~qinfer_tpu_torch.domains.MultinomialDomain`
    (``qinfer_tpu/derived_models.py:345``): expparams gain ``n_meas``, and
    the likelihood is the multinomial pmf of the counts at the underlying
    model's category probabilities.

    :param int n_meas_max: upper bound on ``n_meas``. The design scorers'
        outcome grid holds every count vector with total ≤ ``n_meas_max``,
        C(n_meas_max + k, k) of them, and refuses to be built above
        200 000 (``ValueError``); updates and simulation never need it.
    """

    outcome_ndim = 1

    #: the outcome grid's largest size
    MAX_GRID = 200_000

    def __init__(self, underlying_model, n_meas_max=32):
        super().__init__(underlying_model)
        self.n_elements = int(underlying_model.n_outcomes(None))
        self.n_meas_max = int(n_meas_max)

    @property
    def expparams_dtype(self):
        return list(self.underlying_model.expparams_dtype) + [
            ("n_meas", "int32")]

    @property
    def is_n_outcomes_constant(self):
        return False

    def n_outcomes(self, expparams=None):
        """Rows of the padded outcome grid: C(n_meas_max + k, k)."""
        return comb(self.n_meas_max + self.n_elements, self.n_elements)

    def outcomes(self, expparams=None, device=None):
        """The padded outcome grid (C(n_meas_max + k, k), k) int32: every
        count vector with total ≤ ``n_meas_max``, built on the host once
        (the compositions of ``n_meas_max`` into k + 1 parts, the slack
        part dropped) and copied to each device once. For each experiment
        the rows summing to its ``n_meas`` are real
        (:meth:`outcome_mask`)."""
        cache = self.__dict__.setdefault("_grid_on", {})
        key = torch.device(device) if device is not None else None
        if key not in cache:
            n_out = self.n_outcomes()
            if n_out > self.MAX_GRID:
                raise ValueError(
                    f"MultinomialModel's static outcome grid would hold "
                    f"{n_out} count vectors (n_meas_max={self.n_meas_max}, "
                    f"{self.n_elements} outcomes) — design-time "
                    f"marginalization (bayes_risk / "
                    f"expected_information_gain) is intractable at this "
                    f"size; reduce n_meas_max. Simulation and likelihood "
                    f"updates do not need this grid and keep working.")
            grid = np.array([c[:-1] for c in _compositions(
                self.n_meas_max, self.n_elements + 1)], dtype=np.int32)
            cache[key] = torch.as_tensor(grid, device=device)
        return cache[key]

    def outcome_mask(self, expparams):
        """(n_outcomes, n_expparams): a grid row is a real outcome of an
        experiment when its total equals that experiment's ``n_meas``."""
        n_meas = self.canonicalize_expparams(expparams)["n_meas"]
        totals = torch.sum(self.outcomes(device=n_meas.device), dim=-1)
        return totals[:, None] == n_meas[None, :]

    def domain(self, expparams=None):
        if expparams is None:
            return MultinomialDomain(self.n_meas_max, self.n_elements)
        n_meas = self.canonicalize_expparams(expparams)["n_meas"]
        return [MultinomialDomain(int(m), self.n_elements)
                for m in n_meas.tolist()]

    def _category_probs(self, modelparams, eps):
        """The underlying model's category probabilities (n_m, n_e, k)."""
        sub_eps = {k: v for k, v in eps.items() if k != "n_meas"}
        cats = torch.arange(self.n_elements, dtype=torch.int32,
                            device=modelparams.device)
        L = self.underlying_model.likelihood(cats, modelparams, sub_eps)
        return L.movedim(0, -1)

    def likelihood(self, outcomes, modelparams, expparams):
        """``outcomes`` (n_out, k) count vectors: (n_out, n_m, n_e)."""
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        probs = self._category_probs(modelparams, eps)
        outcomes = atleast_2d(torch.as_tensor(outcomes,
                                              device=modelparams.device))
        return multinomial_pdf(outcomes[:, None, None, :], probs[None])

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Count vectors ``(repeat, n_models, n_expparams, k)`` (squeezed
        when ``repeat == 1``), int32, under each experiment's own
        ``n_meas``: ``n_meas_max`` uniforms a cell binned by the category
        CDF, the first ``n_meas`` counted; trials that land in no bin (the
        u = 1 edge) go to the last category, so every total equals
        ``n_meas``."""
        self._bump("_sim_count", int(repeat))
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        probs = self._category_probs(modelparams, eps)
        n_meas = eps["n_meas"]
        n_m, n_e, k = probs.shape
        u = torch.rand((int(repeat), n_m, n_e, self.n_meas_max),
                       generator=generator, device=probs.device,
                       dtype=probs.dtype)
        cdf = torch.cumsum(probs, dim=-1)
        cdf = cdf / torch.clamp_min(cdf[..., -1:], EPS)
        active = (torch.arange(self.n_meas_max, device=probs.device)
                  [None, None, None, :] < n_meas[None, None, :, None])
        counts = []
        lower = torch.zeros_like(cdf[..., 0])
        for c in range(k):
            upper = cdf[..., c]
            hit = ((u >= lower[None, :, :, None])
                   & (u < upper[None, :, :, None]) & active)
            counts.append(torch.sum(hit, dim=-1))
            lower = upper
        out = torch.stack(counts, dim=-1).to(torch.int32)
        deficit = n_meas[None, None, :].to(torch.int32) - out.sum(
            dim=-1, dtype=torch.int32)
        out[..., -1] += deficit
        return out[0] if repeat == 1 else out


class MLEModel(DerivedModel):
    """Likelihoods raised to ``likelihood_power``, so that the SMC
    posterior approaches the maximum-likelihood estimate
    (``qinfer_tpu/derived_models.py:475``)."""

    def __init__(self, underlying_model, likelihood_power=1.0):
        super().__init__(underlying_model)
        self.likelihood_power = float(likelihood_power)

    def likelihood(self, outcomes, modelparams, expparams):
        L = self.underlying_model.likelihood(outcomes, modelparams,
                                             expparams)
        return torch.clamp_min(L, EPS) ** self.likelihood_power

    def log_likelihood(self, outcomes, modelparams, expparams):
        """``power · max(log L, log EPS)``: annealing widens the exponent
        range, so the stable log path matters more here."""
        logL = self.underlying_model.log_likelihood(outcomes, modelparams,
                                                    expparams)
        return self.likelihood_power * torch.clamp_min(logL, math.log(EPS))

    @property
    def has_log_likelihood(self):
        """Only as stable as the model below's log form."""
        return bool(getattr(self.underlying_model, "has_log_likelihood",
                            False))


class RandomWalkModel(DerivedModel):
    """Model parameters that take a random step, drawn from
    ``step_distribution``, after every experiment: tracking of drifting
    parameters (``qinfer_tpu/derived_models.py:506``)."""

    def __init__(self, underlying_model, step_distribution):
        super().__init__(underlying_model)
        self.step_distribution = step_distribution

    @property
    def is_time_dependent(self):
        return True

    def update_timestep(self, generator, modelparams, expparams):
        """``(n_models, n_modelparams, n_expparams)``: each (model,
        experiment) pair takes its own step."""
        modelparams = atleast_2d(modelparams)
        n_e = n_expparams(self.canonicalize_expparams(expparams))
        n_m = modelparams.shape[0]
        steps = self.step_distribution.sample(generator, n_m * n_e)
        steps = steps.reshape(n_m, n_e, -1).to(modelparams.dtype)
        return modelparams[:, :, None] + steps.movedim(1, 2)


class GaussianRandomWalkModel(RandomWalkModel):
    """A Gaussian random walk with a fixed or a LEARNED covariance
    (``qinfer_tpu/derived_models.py:533``).

    Fixed (``model_mu_sigma=False``): the step is N(0, diag(scale²)), or
    N(0, scale) with ``diagonal=False`` and a (d, d) ``scale``. Learned:
    the walk's scales are extra model parameters after the underlying
    ones, so the SMC learns the diffusion rate with the state: d log σ
    (``diagonal=True``) or the d(d+1)/2 entries of the step covariance's
    Cholesky factor in ``np.tril_indices`` order, the diagonal ones as
    log σ and the others unconstrained (``diagonal=False``).
    """

    def __init__(self, underlying_model, scale=0.01, diagonal=True,
                 model_mu_sigma=False):
        from .distributions import MultivariateNormalDistribution

        d = underlying_model.n_modelparams
        scale_np = np.asarray(scale, dtype=np.float64)
        if not diagonal and scale_np.ndim == 2:
            if scale_np.shape != (d, d):
                raise ValueError(f"full-covariance scale must be ({d}, {d})")
            cov = scale_np
        else:
            if scale_np.ndim == 2:
                raise ValueError("matrix scale requires diagonal=False")
            cov = np.diag(np.broadcast_to(scale_np, (d,)) ** 2)
        super().__init__(underlying_model,
                         MultivariateNormalDistribution(np.zeros(d), cov))
        self.diagonal = bool(diagonal)
        self.model_mu_sigma = bool(model_mu_sigma)

    @property
    def _n_underlying(self):
        return self.underlying_model.n_modelparams

    @property
    def _n_extra(self):
        """Learned walk parameters after the underlying ones: d log σ or
        d(d+1)/2 Cholesky entries (0 when the walk is fixed)."""
        if not self.model_mu_sigma:
            return 0
        d = self._n_underlying
        return d if self.diagonal else d * (d + 1) // 2

    @property
    def n_modelparams(self):
        return self._n_underlying + self._n_extra

    @property
    def modelparam_names(self):
        under = list(self.underlying_model.modelparam_names)
        names = list(under)
        if self.model_mu_sigma:
            if self.diagonal:
                names += [f"log_sigma_{n}" for n in under]
            else:
                for i, j in zip(*np.tril_indices(self._n_underlying)):
                    names.append(f"log_sigma_{under[i]}" if i == j
                                 else f"chol_{under[i]}_{under[j]}")
        return names

    @property
    def Q(self):
        if not self.model_mu_sigma:
            return self.underlying_model.Q
        return torch.cat([torch.as_tensor(self.underlying_model.Q),
                          torch.zeros((self._n_extra,))])

    def are_models_valid(self, modelparams):
        """The underlying model's verdict; the walk's coordinates are
        unconstrained."""
        modelparams = atleast_2d(modelparams)
        return self.underlying_model.are_models_valid(
            modelparams[:, :self._n_underlying])

    def canonicalize(self, modelparams):
        modelparams = atleast_2d(modelparams)
        if not self.model_mu_sigma:
            return self.underlying_model.canonicalize(modelparams)
        head = self.underlying_model.canonicalize(
            modelparams[:, :self._n_underlying])
        return torch.cat([head, modelparams[:, self._n_underlying:]], dim=1)

    def likelihood(self, outcomes, modelparams, expparams):
        modelparams = atleast_2d(modelparams)
        return self.underlying_model.likelihood(
            outcomes, modelparams[:, :self._n_underlying], expparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        modelparams = atleast_2d(modelparams)
        return self.underlying_model.simulate_experiment(
            generator, modelparams[:, :self._n_underlying], expparams,
            repeat=repeat)

    def learned_step(self, modelparams, z):
        """The learned walk applied to standard normals ``z`` (n_m, d,
        n_e): each particle's step is σ ⊙ z (diagonal) or L z with L the
        Cholesky factor of its tail; the tail itself does not move.
        Returns ``(n_models, n_modelparams, n_expparams)``."""
        d = self._n_underlying
        n_m, n_e = modelparams.shape[0], z.shape[2]
        theta = modelparams[:, d:]
        if self.diagonal:
            step = z * torch.exp(theta)[:, :, None]
        else:
            ti, tj = np.tril_indices(d)
            on_diag = torch.as_tensor(ti == tj, device=theta.device)
            entries = torch.where(on_diag[None, :], torch.exp(theta), theta)
            L = torch.zeros((n_m, d, d), dtype=modelparams.dtype,
                            device=modelparams.device)
            L[:, torch.as_tensor(ti), torch.as_tensor(tj)] = entries
            step = torch.einsum("mij,mjE->miE", L, z)
        head = modelparams[:, :d, None] + step
        tail = modelparams[:, d:, None].expand(n_m, self._n_extra, n_e)
        return torch.cat([head, tail], dim=1)

    def update_timestep(self, generator, modelparams, expparams):
        modelparams = atleast_2d(modelparams)
        if not self.model_mu_sigma:
            return super().update_timestep(generator, modelparams, expparams)
        n_e = n_expparams(self.canonicalize_expparams(expparams))
        z = torch.randn((modelparams.shape[0], self._n_underlying, n_e),
                        generator=generator, device=modelparams.device,
                        dtype=modelparams.dtype)
        return self.learned_step(modelparams, z)


class ReferencedPoissonModel(DerivedModel):
    """Poisson photon counts referenced to bright and dark rates
    (``qinfer_tpu/derived_models.py:667``): a two-outcome model's Pr(0) = p
    sets the SIGNAL rate p·α + (1 − p)·β, where α (bright) and β (dark)
    are two model parameters after the underlying ones. Experiments carry
    a ``mode``: SIGNAL (0) probes the model, BRIGHT (1) and DARK (2) count
    at α and β alone. Outcomes are counts 0..``max_count``."""

    SIGNAL, BRIGHT, DARK = 0, 1, 2
    outcome_ndim = 0

    def __init__(self, underlying_model, max_count=512):
        if underlying_model.n_outcomes(None) != 2:
            raise ValueError(
                "ReferencedPoissonModel requires a two-outcome model")
        super().__init__(underlying_model)
        self.max_count = int(max_count)

    @property
    def n_modelparams(self):
        return self.underlying_model.n_modelparams + 2

    @property
    def modelparam_names(self):
        return list(self.underlying_model.modelparam_names) + ["alpha",
                                                               "beta"]

    @property
    def expparams_dtype(self):
        return list(self.underlying_model.expparams_dtype) + [
            ("mode", "int32")]

    @property
    def is_n_outcomes_constant(self):
        return True

    def n_outcomes(self, expparams=None):
        return self.max_count + 1

    def domain(self, expparams=None):
        return IntegerDomain(0, self.max_count)

    def outcomes(self, expparams=None, device=None):
        return torch.arange(self.max_count + 1, dtype=torch.int32,
                            device=device)

    def outcome_mask(self, expparams):
        eps = self.canonicalize_expparams(expparams)
        dev = next(iter(eps.values())).device
        return torch.ones((self.max_count + 1, n_expparams(eps)),
                          dtype=torch.bool, device=dev)

    @property
    def Q(self):
        return torch.cat([torch.as_tensor(self.underlying_model.Q),
                          torch.zeros((2,))])

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        base = self.underlying_model.are_models_valid(modelparams[:, :-2])
        alpha, beta = modelparams[:, -2], modelparams[:, -1]
        return base & (alpha >= beta) & (beta >= 0)

    def _rates(self, modelparams, eps):
        """The Poisson rate of each (model, experiment), clipped at EPS."""
        sub_eps = {k: v for k, v in eps.items() if k != "mode"}
        mode = eps["mode"]
        zero = torch.zeros((1,), dtype=torch.int32, device=modelparams.device)
        p = self.underlying_model.likelihood(zero, modelparams[:, :-2],
                                             sub_eps)[0]
        alpha = modelparams[:, -2:-1]
        beta = modelparams[:, -1:]
        rate = torch.where(
            mode[None, :] == self.SIGNAL, p * alpha + (1.0 - p) * beta,
            torch.where(mode[None, :] == self.BRIGHT, alpha.expand_as(p),
                        beta.expand_as(p)))
        return torch.clamp_min(rate, EPS)

    def likelihood(self, outcomes, modelparams, expparams):
        return torch.exp(self.log_likelihood(outcomes, modelparams,
                                             expparams))

    def log_likelihood(self, outcomes, modelparams, expparams):
        """The log-Poisson pmf k log λ − λ − log k!, stable where the
        linear pmf underflows float32."""
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        rate = self._rates(modelparams, eps)
        counts = torch.as_tensor(outcomes, device=rate.device).reshape(
            -1).to(rate.dtype)
        return (counts[:, None, None] * torch.log(rate)[None] - rate[None]
                - torch.lgamma(counts + 1.0)[:, None, None])

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        """Counts ``(repeat, n_models, n_expparams)`` int32 (squeezed when
        ``repeat == 1``): ``torch.poisson`` on the generator, clipped to
        ``max_count``."""
        self._bump("_sim_count", int(repeat))
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        rate = self._rates(modelparams, eps)
        draws = torch.poisson(rate.expand((int(repeat),) + rate.shape)
                              .contiguous(), generator=generator)
        draws = torch.clamp(draws, 0, self.max_count).to(torch.int32)
        return draws[0] if repeat == 1 else draws

    def update_timestep(self, generator, modelparams, expparams):
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        sub_eps = {k: v for k, v in eps.items() if k != "mode"}
        head = self.underlying_model.update_timestep(
            generator, modelparams[:, :-2], sub_eps)
        tail = modelparams[:, -2:, None].expand(-1, 2, head.shape[2])
        return torch.cat([head, tail], dim=1)
