"""Sequential Monte Carlo updater (counterpart of :mod:`qinfer_tpu.smc`:
``SMCState``, the reweighting paths, the update step and the core of
``SMCUpdater``).

The port runs eagerly. One update step is: reweight (the model's fused
hook, the max-shifted log path or the linear path) → normalize → the
model's ``update_timestep`` when it is time-dependent → ESS check →
resample when the ESS fell to ``resample_thresh · n``. The ESS gate,
the zero-weight flag and the step's log-normalization come to the host in
ONE device→host copy per step (the JAX package keeps the gate on the
device with a 0/1-trip ``while_loop``); everything else stays on the
device. A resample adds a few syncs of its own (the Cholesky check and the
early-exit validity redraw).
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from .config import DEFAULT_DEVICE, EPS, resolve_device
from ._exceptions import ResamplerWarning, ZeroWeightError, ZeroWeightWarning
from .abstract_model import expparams_at, n_expparams
from .resamplers import LiuWestResampler
from .utils import particle_covariance_mtx, particle_mean

__all__ = ["SMCState", "SMCUpdater", "resample_interval_gate"]


@dataclasses.dataclass
class SMCState:
    """The state of an SMC run.

    What the device computes stays a tensor (``weights`` (n,),
    ``locations`` (n, d), the 0-d ``log_total_likelihood``, ``min_n_ess``
    and ``resampler_fallback_count``); the counts and flags the host
    decides anyway (``resample_count``, ``just_resampled``,
    ``zero_weight_count``) are Python numbers. The random stream is a
    :class:`torch.Generator` held by the caller, not part of the state.
    """

    weights: torch.Tensor
    locations: torch.Tensor
    resample_count: int
    just_resampled: bool
    log_total_likelihood: torch.Tensor
    min_n_ess: torch.Tensor
    zero_weight_count: int
    resampler_fallback_count: torch.Tensor

    @property
    def n_particles(self):
        return self.weights.shape[0]

    @property
    def n_modelparams(self):
        return self.locations.shape[1]

    @classmethod
    def initial(cls, locations):
        """Fresh uniform-weight state over ``locations``."""
        n = locations.shape[0]
        dev = locations.device
        return cls(
            weights=torch.full((n,), 1.0 / n, dtype=torch.float32,
                               device=dev),
            locations=locations,
            resample_count=0,
            just_resampled=False,
            log_total_likelihood=torch.zeros((), dtype=torch.float32,
                                             device=dev),
            min_n_ess=torch.full((), float(n), dtype=torch.float32,
                                 device=dev),
            zero_weight_count=0,
            resampler_fallback_count=torch.zeros((), dtype=torch.int32,
                                                 device=dev),
        )


def _single_likelihood(model, locations, outcome, eps):
    """Likelihood of ONE outcome under ONE experiment: (n_particles,)."""
    return model.likelihood(outcome.reshape(-1)[:1], locations, eps)[0, :, 0]


def _single_log_likelihood(model, locations, outcome, eps):
    return model.log_likelihood(
        outcome.reshape(-1)[:1], locations, eps)[0, :, 0]


def _reweight(model, weights, locations, outcome, eps):
    """One reweighting: ``(unnormalized hyp, norm, log_norm)`` with
    ``norm = Σ hyp``.

    * A model with a ``fused_reweight`` hook does the whole step itself.
    * A model with a stable ``log_likelihood`` takes the max-shifted path:
      ``hyp_i = w_i exp(logL_i − M)`` with M the max of the posterior
      log-summand, so the largest summand is exactly 1 and the shifted norm
      cannot underflow; ``log_norm`` is rebuilt in log space and M = −inf
      (the outcome is impossible for every weighted particle) reports a
      zero norm.
    * Otherwise the linear path ``hyp = w · L``.
    """
    if getattr(type(model), "fused_reweight", None) is not None:
        res = model.fused_reweight(weights, locations, outcome, eps)
        if res is not None:
            hyp, norm = res
            return hyp, norm, torch.log(torch.clamp_min(norm, EPS))
    if getattr(model, "has_log_likelihood", False):
        log_ell = _single_log_likelihood(model, locations, outcome, eps)
        log_post = torch.log(torch.clamp_min(weights, 0.0)) + log_ell
        M = torch.max(log_post)
        finite = torch.isfinite(M)
        safe_M = torch.where(finite, M, 0.0)
        hyp = torch.exp(log_post - safe_M)
        shifted_norm = torch.sum(hyp)
        log_norm = torch.log(torch.clamp_min(shifted_norm, EPS)) + safe_M
        return hyp, torch.where(finite, shifted_norm, 0.0), log_norm
    ell = _single_likelihood(model, locations, outcome, eps)
    hyp = weights * ell
    norm = torch.sum(hyp)
    return hyp, norm, torch.log(torch.clamp_min(norm, EPS))


def resample_interval_gate(idx, resample_interval):
    """'This step is resample-eligible' for interval-gated loops: every
    ``resample_interval``-th step; ``resample_interval <= 0`` returns
    ``None`` (gate every step)."""
    if resample_interval > 0:
        return (idx % resample_interval) == (resample_interval - 1)
    return None


def _update_step(model, resampler, state, outcome, eps, resample_thresh,
                 zero_weight_thresh, generator, check_resample=True,
                 resample_gate=None):
    """One SMC update: reweight → normalize → (time-dependent models:
    ``update_timestep``) → ESS check → resample.

    :param outcome: the observed outcome (tensor on the state's device).
    :param eps: expparams dict of ONE experiment, on the state's device.
    :param generator: the :class:`torch.Generator` the timestep and the
        resample draw from.
    :param resample_gate: optional bool that additionally gates the
        resample (see :func:`resample_interval_gate`).
    :return: ``(new_state, log_norm, was_zero)`` with ``log_norm`` a float
        and ``was_zero`` a bool.
    """
    n = state.weights.shape[0]
    hyp, norm, log_norm = _reweight(
        model, state.weights, state.locations, outcome, eps)
    was_zero_t = norm <= zero_weight_thresh
    new_w = torch.where(was_zero_t, 1.0 / n,
                        hyp / torch.clamp_min(norm, EPS))
    locs = state.locations
    if model.is_time_dependent:
        locs = model.update_timestep(generator, locs, eps)[:, :, 0]
    ess = 1.0 / torch.sum(new_w * new_w)
    # the step's one device→host copy
    was_zero, below, log_norm_host = torch.stack([
        was_zero_t.to(torch.float32), (ess <= resample_thresh * n)
        .to(torch.float32), log_norm.to(torch.float32)]).tolist()
    do_resample = (bool(check_resample) and below > 0
                   and (resample_gate is None or bool(resample_gate)))

    n_fallback = 0
    if do_resample:
        new_w, locs, n_fallback = resampler.call_with_diagnostics(
            model, generator, new_w, locs)

    new_state = SMCState(
        weights=new_w,
        locations=locs,
        resample_count=state.resample_count + int(do_resample),
        just_resampled=do_resample,
        log_total_likelihood=state.log_total_likelihood + log_norm,
        min_n_ess=torch.minimum(state.min_n_ess, ess),
        zero_weight_count=state.zero_weight_count + int(was_zero > 0),
        resampler_fallback_count=state.resampler_fallback_count + n_fallback,
    )
    return new_state, log_norm_host, was_zero > 0


#: constructor options of the JAX ``SMCUpdater`` that this port does not
#: have yet, with the value that means "off"
_LATER_OPTIONS = {
    "debug_resampling": False,
    "track_resampling_divergence": False,
    "sharding": None,
    "n_mcmc_moves": 0,
    "mcmc_proposal_scale": 2.38,
    "compress_mcmc_record": False,
    "mcmc_canonicalize": True,
    "waste_free_stages": 0,
    "mcmc_method": "rwm",
    "mcmc_adapt": False,
    "mcmc_target_accept": None,
    "waste_free_kernel": "rwm",
    "waste_free_lw_seed": None,
    "waste_free_beta": 0.3,
}


class SMCUpdater:
    """Sequential Monte Carlo Bayesian updater over a particle ensemble.

    :param model: a :class:`~qinfer_tpu_torch.abstract_model.Model`.
    :param int n_particles: ensemble size.
    :param prior: a :class:`~qinfer_tpu_torch.distributions.Distribution`.
    :param float resample_thresh: resample when ``n_ess <= thresh * n``.
    :param resampler: default ``LiuWestResampler(a=0.98)``.
    :param str zero_weight_policy: ``'error'``, ``'warn'`` or ``'reset'``:
        what to do when an outcome annihilates all weights.
    :param float zero_weight_thresh: "all zero" threshold (default 1e-10).
    :param bool canonicalize: apply ``model.canonicalize`` to prior samples.
    :param int seed: seed of the updater's :class:`torch.Generator`.
    :param device: where the ensemble lives; the card by default. Without
        a CUDA device, pass ``device="cpu"``: the default raises there.

    Options of the JAX updater outside this port (rejuvenation moves,
    waste-free stages, sharding, resampling diagnostics) raise
    :class:`NotImplementedError` when set to anything but "off".
    """

    def __init__(self, model, n_particles, prior, resample_thresh=0.5,
                 resampler=None, zero_weight_policy="error",
                 zero_weight_thresh=None, canonicalize=True, seed=0,
                 device=DEFAULT_DEVICE, **options):
        for name, value in options.items():
            if name not in _LATER_OPTIONS:
                raise TypeError(
                    f"SMCUpdater() got an unexpected keyword argument "
                    f"{name!r}")
            if value != _LATER_OPTIONS[name]:
                raise NotImplementedError(
                    f"SMCUpdater option {name}={value!r} is not ported yet")
        if zero_weight_policy not in ("error", "warn", "reset"):
            raise ValueError("zero_weight_policy must be 'error', 'warn' or "
                             "'reset'")
        self.model = model
        self.prior = prior
        self._n_particles = int(n_particles)
        self.resample_thresh = float(resample_thresh)
        self.resampler = (resampler if resampler is not None
                          else LiuWestResampler(a=0.98))
        self.zero_weight_policy = zero_weight_policy
        self.zero_weight_thresh = (float(zero_weight_thresh)
                                   if zero_weight_thresh is not None
                                   else 1e-10)
        self._canonicalize = bool(canonicalize)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.reset()

    # -- state management --------------------------------------------------

    def reset(self, n_particles=None):
        """Draw a fresh ensemble from the prior and re-seed the generator."""
        if n_particles is not None:
            self._n_particles = int(n_particles)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        locations = self.prior.sample(self.generator, self._n_particles)
        if self._canonicalize:
            locations = self.model.canonicalize(locations)
        self._state = SMCState.initial(locations)
        self.data_record = []
        self.normalization_record = []

    @property
    def state(self):
        """The current :class:`SMCState`."""
        return self._state

    @state.setter
    def state(self, new_state):
        self._state = new_state

    @property
    def particle_weights(self):
        return self._state.weights

    @property
    def particle_locations(self):
        return self._state.locations

    @property
    def n_particles(self):
        return self._n_particles

    @property
    def n_ess(self):
        """Effective sample size 1/Σw²."""
        w = self._state.weights
        return float(1.0 / torch.sum(w * w))

    @property
    def min_n_ess(self):
        return float(self._state.min_n_ess)

    @property
    def resample_count(self):
        return self._state.resample_count

    @property
    def just_resampled(self):
        return self._state.just_resampled

    @property
    def resampler_fallback_count(self):
        """Particle slots (over the whole run) where the validity redraw
        exhausted its budget and the slot kept its ancestor's location."""
        return int(self._state.resampler_fallback_count)

    @property
    def log_total_likelihood(self):
        """Log model evidence Σ log Pr(d_k | d_<k)."""
        return float(self._state.log_total_likelihood)

    @property
    def total_likelihood(self):
        return math.exp(self.log_total_likelihood)

    # -- core update -------------------------------------------------------

    def update(self, outcome, expparams, check_for_resample=True):
        """Condition the posterior on one observed outcome (applying the
        zero-weight policy and the ESS-triggered resample)."""
        eps = self.model.canonicalize_expparams(expparams, self.device)
        if n_expparams(eps) != 1:
            eps = expparams_at(eps, 0)
        outcome_t = torch.as_tensor(outcome, device=self.device)
        self.model._bump("_call_count", self.n_particles)
        prev_state = self._state
        new_state, log_norm, was_zero = _update_step(
            self.model, self.resampler, prev_state, outcome_t, eps,
            self.resample_thresh, self.zero_weight_thresh, self.generator,
            check_resample=bool(check_for_resample))
        if was_zero:
            self._handle_zero_weight()
        if new_state.just_resampled:
            self._warn_resampler_fallback(
                int(new_state.resampler_fallback_count
                    - prev_state.resampler_fallback_count))
        self._state = new_state
        self.data_record.append(outcome)
        self.normalization_record.append(math.exp(log_norm))

    def _warn_resampler_fallback(self, n_slots):
        if n_slots > 0:
            warnings.warn(
                f"resampler validity redraw exhausted its budget for "
                f"{n_slots} particle slot(s); those slots kept their "
                f"ancestors' (valid) locations", ResamplerWarning)

    def _handle_zero_weight(self):
        msg = ("all particle weights are numerically zero; the observed "
               "outcome is inconsistent with every particle")
        if self.zero_weight_policy == "error":
            raise ZeroWeightError(msg)
        if self.zero_weight_policy == "warn":
            warnings.warn(msg + " — weights were reset", ZeroWeightWarning)
        # 'reset': the step already substituted uniform weights

    # -- estimators --------------------------------------------------------

    def est_mean(self):
        """Posterior mean, (d,)."""
        return particle_mean(self._state.weights, self._state.locations)

    def est_covariance_mtx(self, corr=False):
        """Posterior covariance (or correlation) matrix, (d, d)."""
        cov = particle_covariance_mtx(self._state.weights,
                                      self._state.locations)
        if corr:
            std = torch.sqrt(torch.clamp_min(torch.diag(cov), EPS))
            cov = cov / std[:, None] / std[None, :]
        return cov
