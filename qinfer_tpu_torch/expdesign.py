"""Adaptive experiment design (counterpart of :mod:`qinfer_tpu.expdesign`):
candidate selection policies, the finite-pool designers
(:func:`design_from_candidates`, :class:`PoolDesigner`) and the
field optimizer :class:`ExperimentDesigner`.

The scores come from :meth:`SMCUpdater.expected_information_gain` and
:meth:`SMCUpdater.bayes_risk` (one batched contraction over particles ×
outcomes × candidates, on the device). :func:`select_candidate` picks on
the device from the caller's :class:`torch.Generator`; the designers read
the pick on the host, once a call, because their callers index host
records with it. ``ExperimentDesigner`` runs its GRID search as one
``bayes_risk`` call a zoom round, and NM and CG through scipy on the host.

Unlike the JAX package, ``policy='auto'`` with ``utility='risk'`` is
refused: the auto gate reads std/|mean| of the scores, which is
scale-free only for non-negative information gains; on negated risks the
mean can sit near zero and the gate then picks softmax for good.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .finite_difference import FiniteDifference

__all__ = ["ExperimentDesigner", "OptimizationAlgorithms",
           "select_candidate", "design_from_candidates", "PoolDesigner"]

_UTILITIES = ("information_gain", "risk")


def _check_utility(utility, policy):
    if utility not in _UTILITIES:
        raise ValueError(f"unknown utility {utility!r} "
                         "(information_gain | risk)")
    if policy == "auto" and utility == "risk":
        raise ValueError(
            "policy='auto' gates on std/|mean| of the scores, which is "
            "meaningful only for non-negative information gains; with "
            "utility='risk' choose 'greedy', 'egreedy' or 'softmax'")


def _egreedy_pick(generator, scores, epsilon):
    dev = scores.device
    explore = torch.rand((), generator=generator, device=dev) < epsilon
    rand_idx = torch.randint(0, scores.shape[0], (), generator=generator,
                             device=dev)
    return torch.where(explore, rand_idx, torch.argmax(scores))


def _softmax_pick(generator, scores, temperature):
    if temperature is None:
        t = torch.clamp_min(torch.std(scores, correction=0), 1e-12)
    else:
        t = float(temperature)
    # centred by the max before dividing: at a tiny t the raw scores / t
    # would swamp the O(1) Gumbel noise, and flat scores would collapse
    # onto index 0 instead of a uniform pick
    z = (scores - torch.max(scores)) / t
    u = torch.rand(scores.shape, generator=generator, device=scores.device,
                   dtype=scores.dtype)
    return torch.argmax(z - torch.log(-torch.log(u)))


def select_candidate(generator, scores, policy="greedy", epsilon=0.1,
                     temperature=None, auto_threshold=0.15):
    """Pick a candidate index from utility ``scores`` (n_candidates,) on
    their device, with no device→host copy.

    Greedy argmax over the one-step information gain is myopic: on an
    informationally complete pool it keeps choosing the currently most
    informative direction. The stochastic policies mix exploration back in:

    - ``'greedy'``: argmax (first of ties);
    - ``'egreedy'``: with probability ``epsilon`` a uniform candidate,
      else argmax;
    - ``'softmax'``: one draw from softmax(scores / T) by the Gumbel-max
      trick; ``temperature=None`` takes T = std(scores);
    - ``'auto'``: egreedy while the relative spread std/|mean| of the
      scores is below ``auto_threshold``, softmax above it (the spread of
      information gains grows with the data, so it stands in for the
      horizon). For non-negative information-gain scores only.

    The stochastic policies draw from ``generator`` (on the scores'
    device) a fixed number of times per call, whichever branch they take.

    :return: a 0-d int64 tensor on the scores' device.
    """
    scores = torch.as_tensor(scores)
    if policy == "greedy":
        return torch.argmax(scores)
    if policy == "egreedy":
        return _egreedy_pick(generator, scores, epsilon)
    if policy == "softmax":
        return _softmax_pick(generator, scores, temperature)
    if policy == "auto":
        rel = torch.std(scores, correction=0) / torch.clamp_min(
            torch.abs(torch.mean(scores)), 1e-12)
        return torch.where(rel < auto_threshold,
                           _egreedy_pick(generator, scores, epsilon),
                           _softmax_pick(generator, scores, temperature))
    raise ValueError(f"unknown candidate-selection policy {policy!r} "
                     "(greedy | egreedy | softmax | auto)")


def _pool_scores(updater, candidate_eps, utility):
    if utility == "information_gain":
        return updater.expected_information_gain(candidate_eps)
    return -updater.bayes_risk(candidate_eps)


def design_from_candidates(updater, candidate_eps, generator=None,
                           policy="greedy", epsilon=0.1, temperature=None,
                           utility="information_gain"):
    """Score a finite pool of candidate experiments against the updater's
    posterior and select one (the finite-pool sibling of
    :meth:`ExperimentDesigner.design_expparams_field`).

    :param updater: a :class:`~qinfer_tpu_torch.smc.SMCUpdater`.
    :param candidate_eps: expparams with leading axis = pool size.
    :param generator: the :class:`torch.Generator` of the stochastic
        policies (required unless ``policy='greedy'``).
    :param str utility: ``'information_gain'`` (maximized) or ``'risk'``
        (``bayes_risk``, minimized: the scores are negated).
    :return: ``(eps_one, index)``: the selected experiment and its pool
        index, a Python int (the call's one device→host copy).
    """
    _check_utility(utility, policy)
    if generator is None and policy != "greedy":
        raise ValueError(f"policy {policy!r} is stochastic: pass generator=")
    eps = updater.model.canonicalize_expparams(candidate_eps, updater.device)
    scores = _pool_scores(updater, eps, utility)
    idx = int(select_candidate(generator, scores, policy=policy,
                               epsilon=epsilon, temperature=temperature))
    return {k: v[idx:idx + 1] for k, v in eps.items()}, idx


class PoolDesigner:
    """A finite-pool designer that rescores the pool only every
    ``rescore_interval`` calls and right after the updater resampled:
    between resamples the posterior, and with it the utility over a fixed
    pool, drifts slowly, so cached scores select nearly as well for a
    fraction of the cost.

    :param updater: a :class:`~qinfer_tpu_torch.smc.SMCUpdater`.
    :param candidate_eps: expparams, leading axis = pool size.
    :param str policy: selection policy (:func:`select_candidate`).
    :param str utility: ``'information_gain'`` or ``'risk'`` (not with
        ``policy='auto'``).
    :param int rescore_interval: rescore every k-th call (1: every call).
    :param bool rescore_on_resample: also rescore whenever the updater's
        ``resample_count`` moved since the cached scores were computed; the
        interval's phase restarts there.
    :param seed: an int seeding the designer's own generator on the
        updater's device, or a :class:`torch.Generator`.
    """

    def __init__(self, updater, candidate_eps, policy="auto", epsilon=0.1,
                 temperature=None, auto_threshold=0.15,
                 utility="information_gain", rescore_interval=1,
                 rescore_on_resample=True, seed=0):
        _check_utility(utility, policy)
        self.updater = updater
        self.candidate_eps = updater.model.canonicalize_expparams(
            candidate_eps, updater.device)
        self.policy = policy
        self.epsilon = float(epsilon)
        self.temperature = temperature
        self.auto_threshold = float(auto_threshold)
        self.utility = utility
        self.rescore_interval = max(int(rescore_interval), 1)
        self.rescore_on_resample = bool(rescore_on_resample)
        if isinstance(seed, torch.Generator):
            self.generator = seed
        else:
            self.generator = torch.Generator(device=updater.device)
            self.generator.manual_seed(int(seed))
        self._scores = None
        # calls since the last rescore (not total calls): a
        # resample-triggered rescore restarts the interval
        self._since_rescore = 0
        self._scored_at_resample = -1
        self.n_rescores = 0

    def __call__(self):
        """Select one experiment: ``(eps_one, index)`` as
        :func:`design_from_candidates` returns them."""
        rc = int(self.updater.state.resample_count)
        stale = (self._scores is None
                 or self._since_rescore >= self.rescore_interval
                 or (self.rescore_on_resample
                     and rc != self._scored_at_resample))
        if stale:
            self._scores = _pool_scores(self.updater, self.candidate_eps,
                                        self.utility)
            self._scored_at_resample = rc
            self._since_rescore = 0
            self.n_rescores += 1
        self._since_rescore += 1
        idx = int(select_candidate(
            self.generator, self._scores, policy=self.policy,
            epsilon=self.epsilon, temperature=self.temperature,
            auto_threshold=self.auto_threshold))
        return ({k: v[idx:idx + 1] for k, v in self.candidate_eps.items()},
                idx)


class OptimizationAlgorithms(enum.Enum):
    """Nelder-Mead and CG (scipy, on the host) and the batched GRID
    search."""

    NM = 0
    CG = 1
    GRID = 2


class ExperimentDesigner:
    """Design locally optimal experiments against an updater's Bayes risk,
    one scalar field of the expparams at a time."""

    def __init__(self, updater, opt_algo=OptimizationAlgorithms.GRID):
        self.updater = updater
        if isinstance(opt_algo, str):
            try:
                opt_algo = OptimizationAlgorithms[opt_algo.upper()]
            except KeyError:
                raise ValueError(
                    f"unknown opt_algo {opt_algo!r}; expected one of "
                    f"{[a.name for a in OptimizationAlgorithms]}")
        if not isinstance(opt_algo, OptimizationAlgorithms):
            raise ValueError("opt_algo must be an OptimizationAlgorithms")
        self.opt_algo = opt_algo
        self._best_guess = None
        self._best_risk = np.inf

    def new_exp(self):
        """Forget the stored guesses (call between experiments)."""
        self._best_guess = None
        self._best_risk = np.inf

    def _risk_of(self, base_eps, field, values, cost_scale_k=0.0,
                 cost_mult=False):
        """Risks (host NumPy) of a batch of values of one scalar field,
        the other fields taken from experiment 0 of ``base_eps``. Cost
        enters whenever ``cost_scale_k != 0`` (added, ``k · cost``) or
        ``cost_mult`` is set (multiplied, ``1 + k · cost``)."""
        values = np.atleast_1d(np.asarray(values, dtype=float))
        n_cand = values.shape[0]
        eps = {k: v[:1].expand((n_cand,) + v.shape[1:])
               for k, v in base_eps.items()}
        tgt = eps[field].dtype if field in eps else torch.float32
        if not tgt.is_floating_point:
            # round, not truncate: truncation collapses grid candidates
            # onto duplicate integers
            values = np.round(values)
        eps[field] = torch.as_tensor(values, device=self.updater.device
                                     ).to(tgt)
        risk = self.updater.bayes_risk(eps)
        if cost_scale_k != 0.0 or cost_mult:
            cost = self.updater.model.experiment_cost(eps).to(risk.device)
            if cost_mult:
                risk = risk * (1.0 + cost_scale_k * cost)
            else:
                risk = risk + cost_scale_k * cost
        return risk.detach().cpu().numpy(), eps

    def design_expparams_field(self, guess, field, cost_scale_k=0.0,
                               disp=False, maxiter=24, maxfun=None,
                               store_guess=False, grad_h=1e-6,
                               cost_mult=False, n_grid=64, n_zoom=3,
                               zoom_factor=0.25, bounds=None):
        """Optimize one scalar field of the expparams.

        :param guess: an expparams record, or a ``Heuristic`` (instance,
            or class to bind to the updater) to call for one.
        :param cost_scale_k: 0 optimizes the risk alone; otherwise
            ``k · experiment_cost`` is added (multiplied with
            ``cost_mult``).
        :param store_guess: keep the best (value, experiment) over calls
            until :meth:`new_exp`, and return it when a later call does
            worse.
        :param bounds: optional ``(lo, hi)`` (either may be None) clamping
            the search to the physically meaningful range.
        :return: the optimized expparams dict (one experiment).
        """
        from .heuristics import Heuristic

        if isinstance(guess, Heuristic):
            base_eps = guess()
        elif isinstance(guess, type) and issubclass(guess, Heuristic):
            base_eps = guess(self.updater)()
        else:
            base_eps = guess
        base_eps = self.updater.model.canonicalize_expparams(
            base_eps, self.updater.device)

        x0 = float(base_eps[field].reshape(-1)[0])
        lo_b = -np.inf if bounds is None or bounds[0] is None else float(
            bounds[0])
        hi_b = np.inf if bounds is None or bounds[1] is None else float(
            bounds[1])

        def clamp(x):
            return float(np.clip(np.asarray(x).ravel()[0], lo_b, hi_b))

        if self.opt_algo is OptimizationAlgorithms.GRID:
            best_x, best_risk = self._grid_search(
                base_eps, field, clamp(x0), cost_scale_k, cost_mult,
                n_grid=n_grid, n_zoom=n_zoom, zoom_factor=zoom_factor,
                lo_b=lo_b, hi_b=hi_b)
        else:
            import scipy.optimize as opt

            def objective(x):
                return float(self._risk_of(
                    base_eps, field, [clamp(x)], cost_scale_k,
                    cost_mult)[0][0])

            if self.opt_algo is OptimizationAlgorithms.NM:
                res = opt.fmin(objective, x0, disp=bool(disp),
                               maxiter=maxiter, maxfun=maxfun,
                               full_output=True)
            else:  # CG
                grad = FiniteDifference(objective, 1, h=grad_h)
                res = opt.fmin_cg(objective, np.atleast_1d(x0), fprime=grad,
                                  disp=bool(disp), maxiter=maxiter,
                                  full_output=True)
            best_x, best_risk = clamp(np.atleast_1d(res[0])[0]), float(res[1])

        if store_guess:
            if best_risk < self._best_risk or self._best_guess is None:
                self._best_risk = best_risk
                self._best_guess = (best_x, dict(base_eps))
            else:
                best_x, stored = self._best_guess
                base_eps = dict(stored)
                best_risk = self._best_risk

        # one designed experiment: the candidates were scored against
        # experiment 0's other fields
        out = {k: v[:1] for k, v in base_eps.items()}
        field_dtype = base_eps[field].dtype
        if not field_dtype.is_floating_point:
            # round (and clamp again) before the cast: the risk was scored
            # at round(best_x)
            best_x = clamp(np.rint(best_x))
        out[field] = torch.full((1,), best_x, dtype=field_dtype,
                                device=self.updater.device)
        if disp:
            print(f"design_expparams_field: {field}={best_x:.6g} "
                  f"risk={best_risk:.6g}")
        return out

    def _grid_search(self, base_eps, field, x0, cost_scale_k, cost_mult,
                     n_grid, n_zoom, zoom_factor, lo_b=-np.inf,
                     hi_b=np.inf):
        """Zooming grid search: each round scores ``n_grid`` values in ONE
        ``bayes_risk`` call, then zooms around the best; every window is
        clipped to the bounds, and finite bounds set the first window."""
        lo = x0 / 10.0 if x0 > 0 else x0 - 1.0
        hi = x0 * 10.0 if x0 > 0 else x0 + 1.0
        if np.isfinite(lo_b):
            lo = lo_b
        if np.isfinite(hi_b):
            hi = hi_b
        best_x, best_risk = x0, np.inf
        for _ in range(max(1, int(n_zoom))):
            lo, hi = max(lo, lo_b), min(hi, hi_b)
            grid = np.linspace(lo, hi, n_grid)
            risks, _ = self._risk_of(base_eps, field, grid, cost_scale_k,
                                     cost_mult)
            i = int(np.argmin(risks))
            if risks[i] < best_risk:
                best_risk = float(risks[i])
                best_x = float(grid[i])
            span = (hi - lo) * zoom_factor
            lo, hi = best_x - span / 2, best_x + span / 2
        return best_x, best_risk
