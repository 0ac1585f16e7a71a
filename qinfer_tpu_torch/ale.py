"""Approximate likelihood estimation (counterpart of :mod:`qinfer_tpu.ale`,
``qinfer_tpu/ale.py:32-205``): ``ALEApproximateModel`` estimates the
likelihood of a simulator that has none by repeated simulation, with the
hedged binomial estimators ``binom_est_p`` and ``binom_est_error``.

The JAX package runs the adaptive sample budget inside ``jit`` as a
``lax.while_loop``; here it is a host loop over chunks of ``samp_step``
simulations with one device→host copy a round (the worst cell's standard
error). The loop stops on the worst cell of the whole ensemble, as the
JAX loop over a sharded array does: on a mesh across processes that
worst cell is reduced over the ranks, one collective a round.
``rounds`` records the rounds of each call.
"""

from __future__ import annotations

import math
import warnings

import torch

from ._exceptions import ApproximationWarning
from .abstract_model import (FiniteOutcomeModel, atleast_2d, n_expparams,
                             per_particle)
from .derived_models import _device_generator
from .parallel.mesh import LOCAL

__all__ = ["ALEApproximateModel", "binom_est_p", "binom_est_error"]


def binom_est_p(n, N, hedge=0.0):
    """Hedged estimate of a binomial parameter: (n + h) / (N + 2h)."""
    return (n + hedge) / (N + 2 * hedge)


def binom_est_error(p, N, hedge=0.0):
    """Standard error of the hedged binomial estimate:
    sqrt(p (1 − p) / (N + 2h + 1))."""
    return torch.sqrt(torch.as_tensor(p) * (1 - p) / (N + 2 * hedge + 1))


class ALEApproximateModel(FiniteOutcomeModel):
    """The likelihood of a finite-outcome ``simulator`` estimated from its
    simulations by a hedged binomial estimator.

    :param float error_tol: target standard error of each estimate.
    :param int min_samp: least simulations a (model, experiment) cell.
    :param int samp_step: simulations a round.
    :param float est_hedge: hedge of the returned estimate.
    :param float adapt_hedge: hedge of the error that sizes the budget.
    :param int max_samp: cap on the simulations a cell (an
        ``ApproximationWarning`` when it cannot reach ``error_tol``).
    :param bool adaptive: ``True``: rounds of ``samp_step`` simulations
        until the worst cell's standard error is at most ``error_tol`` (at
        least ``min_samp`` simulations, at most the budget ``n_samples``);
        ``False``: the whole budget in one batch.

    The budget is ``n_samples`` = ceil((0.25 / tol² − 2h − 1) / samp_step)
    · samp_step (at least ``min_samp``, at most ``max_samp``): the
    worst-case p = ½ reaches ``error_tol``.

    The engine passes a fresh ``generator`` to every likelihood call
    (``wants_likelihood_key``); a direct call without one draws from the
    model's own generator on the particles' device, seeded with 0 at
    first use.
    """

    wants_likelihood_key = True

    def __init__(self, simulator, error_tol=1e-2, min_samp=1, samp_step=10,
                 est_hedge=0.509, adapt_hedge=0.509, max_samp=None,
                 adaptive=True):
        super().__init__()
        if error_tol <= 0 or error_tol > 1:
            raise ValueError("error_tol must be in (0, 1]")
        self.adaptive = bool(adaptive)
        self.simulator = simulator
        self.error_tol = float(error_tol)
        self.min_samp = int(min_samp)
        self.samp_step = int(samp_step)
        self.est_hedge = float(est_hedge)
        self.adapt_hedge = float(adapt_hedge)
        needed = 0.25 / (self.error_tol ** 2) - 2 * self.adapt_hedge - 1
        needed = max(self.min_samp, int(math.ceil(
            max(needed, 1) / self.samp_step) * self.samp_step))
        self.n_samples = int(min(needed, max_samp) if max_samp else needed)
        if max_samp is not None and needed > max_samp:
            warnings.warn(
                f"ALE sample cap {max_samp} cannot reach error_tol="
                f"{self.error_tol}; worst-case std-err is "
                f"{0.5 / math.sqrt(max_samp):.3g}", ApproximationWarning)
        #: simulation rounds of each likelihood call, in call order
        self.rounds = []

    # -- delegation to the simulator ---------------------------------------

    @property
    def n_modelparams(self):
        return self.simulator.n_modelparams

    @property
    def modelparam_names(self):
        return self.simulator.modelparam_names

    @property
    def expparams_dtype(self):
        return self.simulator.expparams_dtype

    def n_outcomes(self, expparams=None):
        return self.simulator.n_outcomes(expparams)

    def domain(self, expparams=None):
        return self.simulator.domain(expparams)

    def are_models_valid(self, modelparams):
        return self.simulator.are_models_valid(modelparams)

    def canonicalize(self, modelparams):
        return self.simulator.canonicalize(modelparams)

    def simulate_experiment(self, generator, modelparams, expparams,
                            repeat=1):
        return self.simulator.simulate_experiment(
            generator, modelparams, expparams, repeat=repeat)

    def update_timestep(self, generator, modelparams, expparams):
        return self.simulator.update_timestep(generator, modelparams,
                                              expparams)

    @property
    def is_time_dependent(self):
        return self.simulator.is_time_dependent

    @property
    def Q(self):
        return self.simulator.Q

    # -- the approximation -------------------------------------------------

    def likelihood(self, outcomes, modelparams, expparams, generator=None):
        """Hedged frequency estimates (n_outcomes, n_models, n_expparams)
        of each requested outcome from simulations drawn on
        ``generator``."""
        self._bump("_call_count")
        modelparams = atleast_2d(modelparams)
        eps = self.canonicalize_expparams(expparams, modelparams.device)
        outcomes = torch.as_tensor(outcomes, device=modelparams.device)
        outcomes = outcomes.reshape(-1)
        if generator is None:
            generator = _device_generator(self, modelparams.device, 0)
        # a sharded ensemble's streams carry its reducer: every shard runs
        # the rounds the whole ensemble needs
        reducer = getattr(generator, "reducer", LOCAL)

        def chunk_counts(n_rep):
            def simulate(g, x):
                sims = self.simulator.simulate_experiment(g, x, eps,
                                                          repeat=n_rep)
                # repeat == 1 comes back squeezed
                return sims[None] if n_rep == 1 else sims

            sims = per_particle(generator, simulate, modelparams, dim=0,
                                out_dim=1)
            return torch.sum(sims[None] == outcomes[:, None, None, None],
                             dim=1, dtype=torch.int32).to(torch.float32)

        if not self.adaptive or self.samp_step >= self.n_samples:
            self.rounds.append(1)
            return binom_est_p(chunk_counts(self.n_samples), self.n_samples,
                               self.est_hedge)
        step = self.samp_step
        max_iters = -(-self.n_samples // step)
        min_iters = max(1, -(-self.min_samp // step))
        counts = torch.zeros((outcomes.shape[0], modelparams.shape[0],
                              n_expparams(eps)), dtype=torch.float32,
                             device=modelparams.device)
        i = 0
        while i < max_iters:
            counts += chunk_counts(step)
            i += 1
            if i < min_iters:
                continue
            n = i * step
            p = binom_est_p(counts, n, self.adapt_hedge)
            # the round's one device→host copy; the worst cell of the whole
            # ensemble, as the JAX package's loop over a sharded array
            worst = reducer.max(torch.max(binom_est_error(
                p, n, self.adapt_hedge)))
            if float(worst) <= self.error_tol:
                break
        self.rounds.append(i)
        return binom_est_p(counts, i * step, self.est_hedge)
