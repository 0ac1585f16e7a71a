"""Model decorators (counterpart of :mod:`qinfer_tpu.derived_models`:
``DerivedModel`` and ``BinomialModel``).

A decorator delegates the model contract to the model it wraps, one named
method at a time; nothing is forwarded by attribute lookup. The engine's
hooks are looked up on the model's type (``smc._reweight``), so a wrapper
that transforms the likelihood never inherits the wrapped model's fused
reweight: ``BinomialModel(AcceleratedPrecessionModel())`` takes the
log-binomial path, not kernel K1's single-shot reweight.
"""

from __future__ import annotations

import torch

from .abstract_model import Model, atleast_2d
from .domains import IntegerDomain
from .utils import log_binomial_pdf

__all__ = ["DerivedModel", "BinomialModel"]


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

    def likelihood(self, outcomes, modelparams, expparams):
        return self.underlying_model.likelihood(outcomes, modelparams,
                                                expparams)

    def log_likelihood(self, outcomes, modelparams, expparams):
        """Pure delegation; advertised (:attr:`has_log_likelihood`) only
        when this decorator does not transform the likelihood and the
        model below has a stable log form."""
        return self.underlying_model.log_likelihood(outcomes, modelparams,
                                                    expparams)

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
