"""Sequential Monte Carlo updater (counterpart of :mod:`qinfer_tpu.smc`:
``SMCState``, the reweighting paths, the update step, ``SMCUpdater`` with
its resample-move options, batch updates, the posterior and region
estimators, and ``SMCUpdaterBCRB``).

The port runs eagerly. One update step is: reweight (the model's fused
hook, the max-shifted log path or the linear path) → normalize → the
model's ``update_timestep`` when it is time-dependent → ESS check →
resample when the ESS fell to ``resample_thresh · n``. The ESS gate,
the zero-weight flag and the step's log-normalization come to the host in
ONE device→host copy per step (the JAX package keeps the gate on the
device with a 0/1-trip ``while_loop``); everything else stays on the
device. A resample adds a few syncs of its own (the Cholesky check and the
early-exit validity redraw). ``SMCUpdater`` can follow each resample with
Metropolis moves over the record of committed outcomes, or replace it by
waste-free resample-move (:mod:`qinfer_tpu_torch.rejuvenation`).
``batch_update`` is a Python loop over the same step (the JAX package
scans it); the region estimators sort on the device and finish on the
host (float64 cumsum, scipy hulls, the MVEE). Outcomes are scalars or,
for ``outcome_ndim = 1`` models, count vectors; a Monte-Carlo likelihood
(``wants_likelihood_key``) gets a ``torch.Generator`` in every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import warnings

import numpy as np
import torch

from .config import DEFAULT_DEVICE, EPS, resolve_device
from ._exceptions import ResamplerWarning, ZeroWeightError, ZeroWeightWarning
from .abstract_model import (DifferentiableModel, FiniteOutcomeModel,
                             expparams_at, keyed_kwargs, n_expparams)
from .derived_models import BinomialModel
from .distributions import ParticleDistribution
from .resamplers import LiuWestResampler
from . import rejuvenation as rj
from .utils import (in_ellipsoid, mvee, particle_covariance_mtx,
                    particle_mean, particle_meanfn, weighted_moments)

__all__ = ["SMCState", "SMCUpdater", "SMCUpdaterBCRB",
           "resample_interval_gate", "score_candidates"]


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


def _lift_outcome(model, outcome):
    """ONE observed outcome shaped for the likelihood contract: (1,) for a
    scalar outcome, (1, k) for a vector outcome (``outcome_ndim = 1``,
    ``MultinomialModel``'s count vectors)."""
    nd = int(getattr(model, "outcome_ndim", 0))
    if nd == 0:
        return outcome.reshape(-1)[:1]
    return outcome.reshape((-1,) + tuple(outcome.shape[-nd:]))[:1]


def _single_likelihood(model, locations, outcome, eps, generator=None):
    """Likelihood of ONE outcome under ONE experiment: (n_particles,). A
    keyed model draws its noise from ``generator``."""
    return model.likelihood(_lift_outcome(model, outcome), locations, eps,
                            **keyed_kwargs(model, generator))[0, :, 0]


def _single_log_likelihood(model, locations, outcome, eps, generator=None):
    return model.log_likelihood(_lift_outcome(model, outcome), locations,
                                eps, **keyed_kwargs(model, generator))[0, :, 0]


def _reweight(model, weights, locations, outcome, eps, generator=None):
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

    A keyed model (``wants_likelihood_key``) draws its likelihood's noise
    from ``generator``, so it is fresh on every step.
    """
    if getattr(type(model), "fused_reweight", None) is not None:
        res = model.fused_reweight(weights, locations, outcome, eps)
        if res is not None:
            hyp, norm = res
            return hyp, norm, torch.log(torch.clamp_min(norm, EPS))
    if getattr(model, "has_log_likelihood", False):
        log_ell = _single_log_likelihood(model, locations, outcome, eps,
                                         generator)
        log_post = torch.log(torch.clamp_min(weights, 0.0)) + log_ell
        M = torch.max(log_post)
        finite = torch.isfinite(M)
        safe_M = torch.where(finite, M, 0.0)
        hyp = torch.exp(log_post - safe_M)
        shifted_norm = torch.sum(hyp)
        log_norm = torch.log(torch.clamp_min(shifted_norm, EPS)) + safe_M
        return hyp, torch.where(finite, shifted_norm, 0.0), log_norm
    ell = _single_likelihood(model, locations, outcome, eps, generator)
    hyp = weights * ell
    norm = torch.sum(hyp)
    return hyp, norm, torch.log(torch.clamp_min(norm, EPS))


def _one_call_a_trial(model):
    """Whether the batched trial engine evaluates ``model`` one trial at a
    time: a model whose reweight reaches a hand kernel through
    ``fused_reweight`` (K1 takes one ensemble a launch) or whose
    likelihood draws Monte-Carlo noise from a generator (which
    ``torch.func.vmap`` cannot carry). Every other model takes one
    vmapped call for all trials."""
    return (getattr(type(model), "fused_reweight", None) is not None
            or bool(getattr(model, "wants_likelihood_key", False)))


def _trial(eps, t):
    """Trial ``t``'s experiment from a batched one ((T, 1, ...) fields)."""
    return {k: v[t] for k, v in eps.items()}


def _reweight_batch(model, weights, locations, outcomes, eps,
                    generator=None):
    """:func:`_reweight` for T independent ensembles, each against its own
    outcome and experiment: ``weights`` (T, n), ``locations`` (T, n, d),
    ``outcomes`` (T,) (or (T, k) vector outcomes), ``eps`` fields
    (T, 1, ...). Returns ``(unnormalized hyp (T, n), norm (T,))`` by the
    same three paths; the likelihood of every trial comes from one
    ``torch.func.vmap`` call over the trial axis (never a T × T cross
    product), or from one call a trial for the models of
    :func:`_one_call_a_trial`."""
    T = weights.shape[0]
    if _one_call_a_trial(model):
        res = [_reweight(model, weights[t], locations[t], outcomes[t],
                         _trial(eps, t), generator) for t in range(T)]
        return (torch.stack([r[0] for r in res]),
                torch.stack([r[1].reshape(()) for r in res]))
    if getattr(model, "has_log_likelihood", False):
        log_ell = torch.func.vmap(
            lambda x, o, e: _single_log_likelihood(model, x, o, e))(
            locations, outcomes, eps)
        log_post = torch.log(torch.clamp_min(weights, 0.0)) + log_ell
        M = torch.max(log_post, dim=1, keepdim=True).values
        finite = torch.isfinite(M)
        hyp = torch.exp(log_post - torch.where(finite, M, 0.0))
        return hyp, torch.where(finite[:, 0], torch.sum(hyp, dim=1), 0.0)
    ell = torch.func.vmap(
        lambda x, o, e: _single_likelihood(model, x, o, e))(
        locations, outcomes, eps)
    hyp = weights * ell
    return hyp, torch.sum(hyp, dim=1)


def _outcome_likelihoods(model, outcomes, true_mps, eps):
    """The likelihood of each of ``outcomes`` for each of T trials at its
    own true parameters (``true_mps`` (T, 1, d)) under its own experiment
    (fields (T, 1, ...)): (T, n_out), from one ``torch.func.vmap`` call."""
    return torch.func.vmap(
        lambda x, e: model.likelihood(outcomes, x, e)[:, 0, 0])(
        true_mps, eps)


def _simulate_batch(model, generator, true_mps, eps):
    """One outcome for each of T trials at its own true parameters
    ``true_mps`` (T, 1, d) under its own experiment (fields (T, 1, ...)):
    (T,) scalar outcomes, as the trial engines take them. A finite-outcome model with the generic sampler
    gets one vmapped likelihood call and one uniform a trial (the inverse
    CDF of ``FiniteOutcomeModel.simulate_experiment``); any other model
    (its own sampler, or :func:`_one_call_a_trial`) one call a trial."""
    T = true_mps.shape[0]
    generic = (isinstance(model, FiniteOutcomeModel)
               and type(model).simulate_experiment
               is FiniteOutcomeModel.simulate_experiment
               and getattr(model, "is_n_outcomes_constant", True)
               and not _one_call_a_trial(model))
    if not generic:
        return torch.stack([model.simulate_experiment(
            generator, true_mps[t], _trial(eps, t)).reshape(-1)[0]
            for t in range(T)])
    outcomes = model.outcomes(_trial(eps, 0), device=true_mps.device)
    L = _outcome_likelihoods(model, outcomes, true_mps, eps)
    cdf = torch.cumsum(torch.clamp_min(L, EPS), dim=1)
    u = torch.rand((T, 1), generator=generator, device=cdf.device,
                   dtype=cdf.dtype)
    idx = torch.sum(cdf <= u * cdf[:, -1:], dim=1)
    return outcomes[idx.clamp_max(outcomes.shape[0] - 1)]


def _pool_key(eps_np):
    """The rejuvenation pool's identity of one experiment (host arrays,
    ``n_meas`` already left out): each field's name, ``=`` and raw bytes,
    in sorted field order, joined by NUL. ``SMCUpdater._pool_index`` maps
    it to the experiment's pool row; a restored checkpoint rebuilds the
    index with it."""
    return b"\x00".join(
        k.encode() + b"=" + np.ascontiguousarray(eps_np[k]).tobytes()
        for k in sorted(eps_np))


def _likelihood_grid(model, outcomes, locations, eps, generator=None):
    """The scorers' likelihood table (n_out, n, n_cand). A model whose
    likelihood draws Monte-Carlo noise (``wants_likelihood_key``) draws
    it from ``generator``, a stream the caller keeps apart from the
    update's (``SMCUpdater`` passes its design generator), so every design
    call sees fresh noise."""
    return model.likelihood(outcomes, locations, eps,
                            **keyed_kwargs(model, generator))


def _hypothetical_update(model, weights, locations, outcomes, eps,
                         generator=None):
    """Posterior weights for every (outcome, experiment) hypothesis:
    ``(norm_weights (n_out, n_eps, n), L (n_out, n, n_eps), norms
    (n_out, n_eps))``."""
    L = _likelihood_grid(model, outcomes, locations, eps, generator)
    hyp = L * weights[None, :, None]
    norms = torch.sum(hyp, dim=1)
    norm_w = hyp.movedim(1, 2) / torch.clamp_min(norms, EPS)[..., None]
    return norm_w, L, norms


def _bayes_risk(model, weights, locations, outcomes, mask, eps, Q,
                generator=None):
    """Expected posterior Q-weighted variance, marginalized over outcomes:
    risk(e) = Σ_o Pr(o|e) · Σ_j Q_j Var[θ_j | o, e]; padded outcome slots
    (``mask`` 0) contribute nothing.

    Two products of the likelihood table against the weighted raw moments,
    ``N = L·w`` and ``M = L·(w ⊙ [x, x²])``, normalized at the small
    (n_out, n_cand, 2d) output: no per-particle posterior is built."""
    L = _likelihood_grid(model, outcomes, locations, eps, generator)
    L = L * mask[:, None, :]
    d = locations.shape[1]
    xaug = torch.cat([locations, locations * locations], dim=1)
    N = torch.matmul(weights, L)  # (n_out, n_cand): Pr(outcome | e)
    M = torch.matmul(L.transpose(1, 2), weights[:, None] * xaug)
    del L
    inv_n = 1.0 / torch.clamp_min(N, EPS)[..., None]
    mu = M[..., :d] * inv_n
    x2 = M[..., d:] * inv_n
    var = torch.clamp_min(x2 - mu * mu, 0.0)
    q = Q.to(device=var.device, dtype=var.dtype, non_blocking=True)
    risk_per_outcome = var @ q  # (n_out, n_cand)
    return torch.sum(N * risk_per_outcome, dim=0)


def _expected_information_gain(model, weights, locations, outcomes, mask,
                               eps, generator=None):
    """Mutual information (nats) between the outcome and the parameters
    for each candidate: IG(e) = H[Pr(o|e)] − E_θ H[Pr(o|θ,e)], with padded
    outcome slots (``mask`` 0) contributing nothing. Holds at most two
    (n_out, n, n_cand) tables at once beside the model's own."""
    L = _likelihood_grid(model, outcomes, locations, eps, generator)
    L = L * mask[:, None, :]
    marg = torch.matmul(weights, L)  # (n_out, n_cand): Pr(o | e)
    h_marg = -torch.sum(marg * torch.log(torch.clamp_min(marg, EPS)), dim=0)
    # L·log L in place on the clamped copy
    ll = torch.clamp_min(L, EPS).log_().mul_(L)
    del L
    h_cond_per_theta = -torch.sum(ll, dim=0)  # (n, n_cand)
    del ll
    return h_marg - weights @ h_cond_per_theta


def _outcome_grid(model, eps, weights):
    """The model's outcome grid for ``eps`` on the weights' device, and its
    mask (n_out, n_eps) in the weights' dtype."""
    outcomes = model.outcomes(eps, device=weights.device)
    return outcomes, model.outcome_mask(eps).to(weights.dtype)


def score_candidates(score_fn, model, weights, locations, eps, extra_args=(),
                     candidate_chunk=None, generator=None):
    """Score the candidate experiments ``eps`` (a canonical dict on the
    particles' device) with ``score_fn(model, w, x, outcomes, mask, eps,
    *extra_args)``, optionally ``candidate_chunk`` at a time: the pool is
    padded to a multiple of the chunk by repeating its last candidate, each
    chunk is scored with its own outcome mask, and the result is cut back
    to the pool. The likelihood table is (n_out, n, n_cand), so a chunk
    bounds the peak memory at a few (n_out, n, chunk) tables whatever the
    pool's size. No device→host copy. A keyed model's likelihood noise
    comes from ``generator``."""
    n_e = n_expparams(eps)
    outcomes, mask = _outcome_grid(model, eps, weights)
    if candidate_chunk is None or n_e <= candidate_chunk:
        return score_fn(model, weights, locations, outcomes, mask, eps,
                        *extra_args, generator=generator)
    c = int(candidate_chunk)
    n_pad = (-n_e) % c
    if n_pad:
        eps = {k: torch.cat([v, v[-1:].expand((n_pad,) + v.shape[1:])])
               for k, v in eps.items()}
    scores = []
    for start in range(0, n_e + n_pad, c):
        ec = {k: v[start:start + c] for k, v in eps.items()}
        scores.append(score_fn(model, weights, locations, outcomes,
                               model.outcome_mask(ec).to(weights.dtype), ec,
                               *extra_args, generator=generator))
    return torch.cat(scores)[:n_e]


def resample_interval_gate(idx, resample_interval):
    """'This step is resample-eligible' for interval-gated loops: every
    ``resample_interval``-th step; ``resample_interval <= 0`` returns
    ``None`` (gate every step). :meth:`SMCUpdater.batch_update` reads
    ``resample_interval <= 0`` the other way, as never checking, as the
    JAX package's does."""
    if resample_interval > 0:
        return (idx % resample_interval) == (resample_interval - 1)
    return None


def _entropy(w):
    """−Σ wᵢ log wᵢ over the nonzero weights."""
    return -torch.sum(torch.where(
        w > 0, w * torch.log(torch.clamp_min(w, EPS)), 0.0))


#: elements of the (block, n_ref, d) difference that the KDE holds at once
_KDE_BLOCK_ELEMENTS = 1 << 22


def _log_kde(pts, w_ref, x_ref, h2):
    """log Σⱼ wⱼ N(pts; xⱼ, h² I) for each point, a block of points at a
    time: the whole (n_pts, n_ref) distance table is O(n²) memory, so each
    block's broadcast difference holds at most ``_KDE_BLOCK_ELEMENTS``."""
    d = pts.shape[1]
    log_w = torch.log(torch.clamp_min(w_ref, EPS))
    log_const = -0.5 * d * torch.log(2 * math.pi * h2)
    n_pts, n_ref = pts.shape[0], x_ref.shape[0]
    block = max(1, min(n_pts, _KDE_BLOCK_ELEMENTS // max(n_ref * d, 1)))
    out = []
    for start in range(0, n_pts, block):
        b = pts[start:start + block]
        d2 = torch.sum((b[:, None, :] - x_ref[None, :, :]) ** 2, dim=-1)
        out.append(torch.logsumexp(-0.5 * d2 / h2 + log_w[None, :], dim=1)
                   + log_const)
    return torch.cat(out)


def _kl_divergence(w_p, x_p, w_q, x_q, kernel_bandwidth=None):
    """D(p ‖ q) between two particle clouds through Gaussian kernel
    density estimates of both at p's particles; the bandwidth defaults to
    Silverman's rule on q's covariance."""
    d = x_p.shape[1]
    if kernel_bandwidth is None:
        cov_q = particle_covariance_mtx(w_q, x_q)
        h2 = torch.clamp_min(torch.trace(cov_q) / d, EPS) * (
            x_q.shape[0] ** (-2.0 / (d + 4)))
    else:
        h2 = torch.as_tensor(float(kernel_bandwidth) ** 2,
                             dtype=x_p.dtype, device=x_p.device)
    return torch.sum(w_p * (_log_kde(x_p, w_p, x_p, h2)
                            - _log_kde(x_p, w_q, x_q, h2)))


def _update_step(model, resampler, state, outcome, eps, resample_thresh,
                 zero_weight_thresh, generator, check_resample=True,
                 resample_gate=None):
    """One SMC update: reweight → normalize → (time-dependent models:
    ``update_timestep``) → ESS check → resample.

    :param outcome: the observed outcome (tensor on the state's device).
    :param eps: expparams dict of ONE experiment, on the state's device.
    :param generator: the :class:`torch.Generator` a keyed model's
        likelihood noise, the timestep and the resample draw from, in that
        order.
    :param resample_gate: optional bool that additionally gates the
        resample (see :func:`resample_interval_gate`).
    :return: ``(new_state, log_norm, was_zero)`` with ``log_norm`` a float
        and ``was_zero`` a bool.
    """
    n = state.weights.shape[0]
    hyp, norm, log_norm = _reweight(
        model, state.weights, state.locations, outcome, eps, generator)
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
    "sharding": None,
}


class SMCUpdater:
    """Sequential Monte Carlo Bayesian updater over a particle ensemble.

    :param model: a :class:`~qinfer_tpu_torch.abstract_model.Model`.
    :param int n_particles: ensemble size.
    :param prior: a :class:`~qinfer_tpu_torch.distributions.Distribution`.
    :param float resample_thresh: resample when ``n_ess <= thresh * n``.
    :param resampler: default ``LiuWestResampler(a=0.98)``, which skips
        its own strict projection when the moves re-project (see below).
    :param str zero_weight_policy: ``'error'``, ``'warn'`` or ``'reset'``:
        what to do when an outcome annihilates all weights.
    :param float zero_weight_thresh: "all zero" threshold (default 1e-10).
    :param bool canonicalize: apply ``model.canonicalize`` to prior samples.
    :param int seed: seed of the updater's :class:`torch.Generator`.
    :param device: where the ensemble lives; the card by default. Without
        a CUDA device, pass ``device="cpu"``: the default raises there.

    Resample-move (:mod:`qinfer_tpu_torch.rejuvenation`):

    :param int n_mcmc_moves: Metropolis sweeps after every resample,
        targeting prior × the likelihood of every committed outcome
        (static models and tractable priors only).
    :param mcmc_proposal_scale: the random walk's scale on the ensemble
        Cholesky factor, over √d. ``None`` means the method's constant
        (2.38 for the random walk, 1.65 for MALA); with adaptation a
        number only seeds the initial scale.
    :param bool compress_mcmc_record: keep the record as per-candidate
        binomial sufficient statistics (two-outcome models and
        ``BinomialModel`` counts): each evaluation costs O(E·n) in the
        number of distinct experiments instead of O(T·n).
    :param bool mcmc_canonicalize: ``model.canonicalize`` after each move
        call (default). ``False`` skips that strict projection: accepted
        proposals already pass ``model.are_models_valid``.
    :param int waste_free_stages: P > 0 replaces the resample and moves by
        waste-free resample-move when the ESS gate fires (n/P ancestors,
        every state of a (P − 1)-step chain kept); needs
        ``compress_mcmc_record=True`` and P | n_particles.
    :param str waste_free_kernel: ``'rwm'`` or ``'pcn'`` chain proposals.
    :param waste_free_lw_seed: optional Liu-West ``a`` perturbing the
        waste-free ancestors once before chaining.
    :param float waste_free_beta: the pCN step size.
    :param str mcmc_method: ``'rwm'`` (random walk) or ``'mala'``
        (Langevin; gradients by autograd).
    :param bool mcmc_adapt: Robbins-Monro adaptation of the step size
        toward ``mcmc_target_accept`` after every sweep; the adapted state
        persists across updates.
    :param float mcmc_target_accept: adaptation target (default 0.234 for
        'rwm', 0.574 for 'mala').

    Resampling diagnostics:

    :param bool debug_resampling: log each resample's ESS before and after
        at DEBUG level (logger ``qinfer_tpu_torch.smc``).
    :param bool track_resampling_divergence: append the KL divergence
        D(before ‖ after) of each resample, waste-free ones included, to
        ``resampling_divergences`` (:meth:`est_kl_divergence`: O(n²) work
        a resample).

    Models whose likelihood is a Monte-Carlo estimate
    (``wants_likelihood_key``: ALE, ``PoisonedModel``) get
    ``generator=``: the updater's own generator in every update step (so
    the noise is fresh each step, as the JAX package's per-step key), and
    a design generator of their own, seeded from ``seed``, in the design
    scorers (so scoring leaves the update's stream untouched, as the JAX
    package's ``_design_key`` does).

    The one option of the JAX updater outside this port, ``sharding``,
    raises :class:`NotImplementedError` when set to anything but ``None``.
    """

    def __init__(self, model, n_particles, prior, resample_thresh=0.5,
                 resampler=None, debug_resampling=False,
                 track_resampling_divergence=False,
                 zero_weight_policy="error",
                 zero_weight_thresh=None, canonicalize=True, seed=0,
                 device=DEFAULT_DEVICE, n_mcmc_moves=0,
                 mcmc_proposal_scale=None, compress_mcmc_record=False,
                 mcmc_canonicalize=True, waste_free_stages=0,
                 mcmc_method="rwm", mcmc_adapt=False,
                 mcmc_target_accept=None, waste_free_kernel="rwm",
                 waste_free_lw_seed=None, waste_free_beta=0.3, **options):
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
        if resampler is None:
            # Moves that re-project (mcmc_canonicalize=True) let the
            # Liu-West resampler skip its own strict projection: one per
            # resample-move event instead of two. At least one strict
            # projection per event is load-bearing at high dimension: with
            # both off, the 255-parameter process flagship collapsed from
            # fidelity 0.98 to 0.48-0.65 (the JAX package's measurement),
            # posterior mass leaking into the psd_tol shell.
            resampler = LiuWestResampler(
                a=0.98, canonicalize=not (int(n_mcmc_moves) > 0
                                          and int(waste_free_stages) == 0
                                          and bool(mcmc_canonicalize)))
        self.resampler = resampler
        self.debug_resampling = bool(debug_resampling)
        self.track_resampling_divergence = bool(track_resampling_divergence)
        self.zero_weight_policy = zero_weight_policy
        self.zero_weight_thresh = (float(zero_weight_thresh)
                                   if zero_weight_thresh is not None
                                   else 1e-10)
        self._canonicalize = bool(canonicalize)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.n_mcmc_moves = int(n_mcmc_moves)
        self.mcmc_proposal_scale = (None if mcmc_proposal_scale is None
                                    else float(mcmc_proposal_scale))
        self.mcmc_canonicalize = bool(mcmc_canonicalize)
        self.mcmc_method = str(mcmc_method)
        self.mcmc_adapt = bool(mcmc_adapt)
        self.waste_free_stages = int(waste_free_stages)
        self._rejuvenating = (self.n_mcmc_moves > 0
                              or self.waste_free_stages > 0)
        # the adaptive core: MALA, or adaptation asked for (with
        # adapt=False it is fixed-scale MALA)
        self._use_adaptive_kernel = (self.n_mcmc_moves > 0
                                     and (self.mcmc_adapt
                                          or self.mcmc_method != "rwm"))
        self.mcmc_target_accept = None
        self._mcmc_log_scale0 = 0.0
        if self.mcmc_adapt or self.mcmc_method != "rwm":
            self.mcmc_target_accept = (
                rj.default_target_accept(self.mcmc_method)
                if mcmc_target_accept is None else float(mcmc_target_accept))
            if (self.mcmc_method == "mala"
                    and getattr(model, "wants_likelihood_key", False)):
                raise ValueError(
                    "mcmc_method='mala' requires a deterministic "
                    "likelihood (Monte-Carlo likelihoods have no usable "
                    "gradient; use mcmc_method='rwm')")
            if self.waste_free_stages > 0:
                raise ValueError(
                    "mcmc_adapt / mcmc_method='mala' apply to the "
                    "post-resample move kernel (n_mcmc_moves), not the "
                    "waste-free kernel")
            # None seeds the method's optimal-scaling constant; a number
            # (2.38 included) seeds the scale itself
            self._mcmc_log_scale0 = rj.initial_log_scale(
                int(model.n_modelparams), self.mcmc_method,
                self.mcmc_proposal_scale)
        if self._rejuvenating:
            if bool(model.is_time_dependent):
                raise ValueError(
                    "n_mcmc_moves > 0 is incompatible with time-dependent "
                    "models: past-data likelihood is not the posterior of "
                    "parameters that moved between experiments")
            rj.resolve_prior_log_pdf(prior)  # raises if intractable
        self.compress_mcmc_record = bool(compress_mcmc_record)
        self.waste_free_kernel = str(waste_free_kernel)
        self.waste_free_lw_seed = (None if waste_free_lw_seed is None
                                   else float(waste_free_lw_seed))
        self.waste_free_beta = float(waste_free_beta)
        if self.waste_free_kernel not in ("rwm", "pcn"):
            raise ValueError(
                f"unknown waste_free_kernel {self.waste_free_kernel!r} "
                "(rwm | pcn)")
        if self.waste_free_stages > 0:
            if not self.compress_mcmc_record:
                raise ValueError(
                    "waste_free_stages > 0 requires "
                    "compress_mcmc_record=True (the chain targets the "
                    "sufficient-statistic record)")
            if self._n_particles % self.waste_free_stages:
                raise ValueError(
                    f"waste_free_stages={self.waste_free_stages} must "
                    f"divide n_particles={self._n_particles}")
            if zero_weight_policy == "error":
                raise ValueError(
                    "waste_free_stages > 0 is incompatible with "
                    "zero_weight_policy='error'")
        # success := underlying outcome 0, counted by BinomialModel
        self._record_is_binomial = isinstance(model, BinomialModel)
        if self.compress_mcmc_record:
            if not self._rejuvenating:
                raise ValueError("compress_mcmc_record=True requires "
                                 "n_mcmc_moves > 0 or waste_free_stages "
                                 "> 0 (it only affects the rejuvenation "
                                 "record)")
            if not (self._record_is_binomial
                    or (getattr(model, "is_n_outcomes_constant", True)
                        and model.n_outcomes(None) == 2)):
                raise ValueError(
                    "compress_mcmc_record=True requires a two-outcome "
                    "model or a BinomialModel over one (the record "
                    "factorizes through per-candidate binomial "
                    "sufficient statistics)")
            if getattr(rj._two_outcome(model), "wants_likelihood_key",
                       False):
                raise ValueError(
                    "compress_mcmc_record=True requires a deterministic "
                    "two-outcome likelihood (Monte-Carlo likelihoods "
                    "cannot reproduce per-record-step noise from "
                    "compressed statistics)")
        self.reset()

    # -- state management --------------------------------------------------

    def reset(self, n_particles=None):
        """Draw a fresh ensemble from the prior and re-seed the generator."""
        if n_particles is not None:
            self._n_particles = int(n_particles)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        # the design scorers' stream for keyed likelihoods: its own seed,
        # so that scoring leaves the update's stream where it was
        self._design_generator = None
        if getattr(self.model, "wants_likelihood_key", False):
            self._design_generator = torch.Generator(device=self.device)
            self._design_generator.manual_seed(int(
                np.random.SeedSequence([self.seed, 1]).generate_state(1)[0]))
        locations = self.prior.sample(self.generator, self._n_particles)
        if self._canonicalize:
            locations = self.model.canonicalize(locations)
        self._state = SMCState.initial(locations)
        self.data_record = []
        self.normalization_record = []
        # the rejuvenation record: every experiment (full record), or a
        # host-side pool of distinct experiments with success and trial
        # totals (compressed record)
        self._eps_record = []
        self._n_record = 0
        self._pool_index = {}
        self._pool_eps = []
        self._pool_succ = []
        self._pool_trials = []
        # the adaptive kernel's Robbins-Monro state, read from the device
        # once per move call
        self._mcmc_log_scale = float(self._mcmc_log_scale0)
        self._mcmc_adapt_t = 0
        self.mcmc_acceptance_record = []
        self.resampling_divergences = (
            [] if self.track_resampling_divergence else None)

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

    @contextlib.contextmanager
    def _engine_count(self, k):
        """Leave the model's ``call_count`` at ``k`` more than before, as
        the JAX package counts an engine call: likelihood evaluations the
        engine asked for, one per (outcome, particle, experiment), whatever
        the eager likelihood calls inside bump themselves (under the JAX
        package's ``jit`` those land on a copy of the model)."""
        count = self.model.call_count + k
        try:
            yield
        finally:
            self.model._call_count = count

    def update(self, outcome, expparams, check_for_resample=True):
        """Condition the posterior on one observed outcome (applying the
        zero-weight policy, the ESS-triggered resample and, when
        configured, the resample-move)."""
        eps = self.model.canonicalize_expparams(expparams, self.device)
        if n_expparams(eps) != 1:
            eps = expparams_at(eps, 0)
        self._update_one(outcome, torch.as_tensor(outcome, device=self.device),
                         eps, bool(check_for_resample))

    def batch_update(self, outcomes, expparams, resample_interval=5):
        """Condition on a record of (outcome, experiment) pairs, one update
        step each, checking the ESS only on every ``resample_interval``-th
        step (``idx % k == k − 1``); ``resample_interval <= 0`` never
        checks. It equals the loop ``update(o_i, e_i,
        check_for_resample=(i % k == k − 1))`` to the bit: waste-free
        resample-move obeys the same gate, moves follow each resample with
        the record up to and including its step, and a zero-weight step
        under ``'error'`` raises with every step before it committed.

        The outcomes and experiments come to the device and their record
        values to the host once for the batch, so a step costs the update
        step's one device→host copy and no other. Returns the steps'
        normalizations (float64, host)."""
        eps = self.model.canonicalize_expparams(expparams, self.device)
        outcomes_t = torch.atleast_1d(torch.as_tensor(outcomes)).to(
            self.device)
        values = outcomes_t.cpu().tolist()
        eps_host = None
        if self._rejuvenating and self.compress_mcmc_record:
            eps_host = {k: v.cpu().numpy() for k, v in eps.items()}
        k = int(resample_interval)
        first = len(self.normalization_record)
        for i in range(len(values)):
            host = None
            if eps_host is not None:
                host = (values[i],
                        {f: v[i:i + 1] for f, v in eps_host.items()})
            self._update_one(values[i], outcomes_t[i:i + 1],
                             expparams_at(eps, i), k > 0 and i % k == k - 1,
                             host)
        return np.asarray(self.normalization_record[first:], np.float64)

    def _update_one(self, outcome, outcome_t, eps, check, host=None):
        """One committed update of :meth:`update` and :meth:`batch_update`:
        ``outcome`` is the record's value, ``outcome_t`` and ``eps`` (one
        experiment) are on the device, and ``host`` optionally carries the
        outcome and experiment as host values for the compressed record.
        A zero-weight step under ``'error'`` raises before it commits."""
        with self._engine_count(self.n_particles):
            prev_state = self._state
            new_state, log_norm, was_zero = _update_step(
                self.model, self.resampler, prev_state, outcome_t, eps,
                self.resample_thresh, self.zero_weight_thresh, self.generator,
                check_resample=check and self.waste_free_stages == 0)
            if was_zero:
                self._handle_zero_weight()
            if new_state.just_resampled:
                self._warn_resampler_fallback(
                    int(new_state.resampler_fallback_count
                        - prev_state.resampler_fallback_count))
                self._on_resample_diagnostics(prev_state, new_state)
            self._state = new_state
            self.data_record.append(outcome)
            self.normalization_record.append(math.exp(log_norm))
            if not self._rejuvenating:
                return
            self._n_record += 1
            if self.compress_mcmc_record:
                # the sufficient statistics alone: storing every
                # experiment would defeat the record's compression
                self._accumulate_record(outcome, eps, host)
            else:
                self._eps_record.append(eps)
            if self.waste_free_stages > 0:
                # a caller that suppresses the resample gets no waste-free
                # resample-move either
                if check and (self.n_ess
                              <= self.resample_thresh * self._n_particles):
                    self._waste_free_now()
            elif new_state.just_resampled:
                self._rejuvenate_now()

    def _on_resample_diagnostics(self, prev_state, new_state):
        """The opt-in resampling diagnostics of one resample event
        (``track_resampling_divergence``, ``debug_resampling``); nothing
        runs, and nothing syncs, when both are off."""
        if self.track_resampling_divergence:
            self.resampling_divergences.append(float(_kl_divergence(
                prev_state.weights, prev_state.locations,
                new_state.weights, new_state.locations)))
        if self.debug_resampling:
            logging.getLogger(__name__).debug(
                "resample #%d: n_ess %.1f -> %.1f", new_state.resample_count,
                float(1.0 / torch.sum(prev_state.weights ** 2)),
                float(1.0 / torch.sum(new_state.weights ** 2)))

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

    def resample(self):
        """Resample now, whatever the ESS, count it, and fire the moves
        (``n_mcmc_moves``). A resampler that skips its strict projection
        relies on the moves' one; when no move will project (none
        configured, an empty record, or ``mcmc_canonicalize=False``), this
        resample applies ``model.canonicalize`` itself."""
        st = self._state
        with self._engine_count(0):
            new_w, new_x, n_fallback = self.resampler.call_with_diagnostics(
                self.model, self.generator, st.weights, st.locations)
            moves_will_project = (self.n_mcmc_moves > 0
                                  and self.mcmc_canonicalize
                                  and self._n_record > 0)
            if (not getattr(self.resampler, "canonicalize", True)
                    and not moves_will_project):
                new_x = self.model.canonicalize(new_x)
            self._warn_resampler_fallback(int(n_fallback))
            self._state = dataclasses.replace(
                st, weights=new_w, locations=new_x,
                resample_count=st.resample_count + 1, just_resampled=True,
                resampler_fallback_count=(st.resampler_fallback_count
                                          + n_fallback))
            if self.n_mcmc_moves > 0:
                self._rejuvenate_now()

    # -- resample-move rejuvenation ----------------------------------------

    def _pool_row_and_increment(self, outcome_val, eps_np):
        """The sufficient-statistic conventions, in one place: success :=
        underlying outcome 0 (``BinomialModel``'s convention), a Bernoulli
        bit is a binomial of one trial, and ``n_meas`` rides in the trial
        totals, not in the pool identity. Takes host values, creates the
        pool row if new and returns ``(row, success_inc, trial_inc)``."""
        eps_np = dict(eps_np)
        n_meas = 1
        if self._record_is_binomial:
            n_meas = int(eps_np.pop("n_meas").ravel()[0])
        key_bytes = _pool_key(eps_np)
        row = self._pool_index.get(key_bytes)
        if row is None:
            row = len(self._pool_eps)
            self._pool_index[key_bytes] = row
            self._pool_eps.append(eps_np)
            self._pool_succ.append(0.0)
            self._pool_trials.append(0.0)
        o = float(outcome_val)
        s_inc = o if self._record_is_binomial else (1.0 if o == 0 else 0.0)
        return row, s_inc, float(n_meas)

    def _accumulate_record(self, outcome, eps, host=None):
        """Fold one committed (outcome, experiment) into the per-candidate
        totals: from ``host``, the pair as host values, when given, else
        with one device→host copy of the experiment."""
        if host is None:
            host = (torch.as_tensor(outcome).reshape(-1)[0].item(),
                    {k: v.detach().cpu().numpy() for k, v in eps.items()})
        row, s_inc, t_inc = self._pool_row_and_increment(*host)
        self._pool_succ[row] += s_inc
        self._pool_trials[row] += t_inc

    def _pool_arrays(self):
        """The compressed record on the device: the pool's experiments
        padded to a power of two ≥ 8 (padding rows repeat row 0 with zero
        trials, which add exactly 0), and int32 success and trial totals
        (float32 stops counting at 2²⁴; the likelihood casts at use)."""
        E = len(self._pool_eps)
        Ep = max(8, 1 << (E - 1).bit_length()) if E > 1 else 8
        pad = Ep - E
        pool_eps = {
            k: torch.as_tensor(np.concatenate(
                [np.atleast_1d(e[k]) for e in self._pool_eps]
                + ([np.repeat(np.atleast_1d(self._pool_eps[0][k]), pad,
                              axis=0)] if pad else []), axis=0),
                device=self.device)
            for k in self._pool_eps[0]
        }
        trials = np.asarray(self._pool_trials, np.float64)
        if trials.size and float(trials.max()) > 2.0 ** 30:
            raise OverflowError(
                "per-candidate trial totals exceed 2^30; the int32 "
                "device representation of the compressed rejuvenation "
                "record would overflow (split the record across "
                "candidates or disable compress_mcmc_record)")
        succ = np.pad(np.asarray(self._pool_succ, np.int64), (0, pad))
        trials = np.pad(trials.astype(np.int64), (0, pad))
        return (pool_eps,
                torch.as_tensor(succ.astype(np.int32), device=self.device),
                torch.as_tensor(trials.astype(np.int32), device=self.device))

    def _record_arrays(self):
        """The full record on the device: ``(outcomes (T,) or (T, k) for
        vector outcomes, expparams with leading axis T)``."""
        nd = int(getattr(self.model, "outcome_ndim", 0))
        outs = [torch.as_tensor(o, device=self.device)
                for o in self.data_record]
        outs = torch.stack([o.reshape(-1)[0] if nd == 0
                            else o.reshape(o.shape[o.ndim - nd:])
                            for o in outs])
        eps_rec = {k: torch.cat([e[k] for e in self._eps_record])
                   for k in self._eps_record[0]}
        return outs, eps_rec

    def _waste_free_now(self):
        """Waste-free resample-move in place of the resample
        (:func:`~qinfer_tpu_torch.rejuvenation.
        waste_free_rejuvenate_binomial`); nothing before the first
        committed experiment. A waste-free kernel is the resample event, so
        it feeds the resampling diagnostics."""
        if self._n_record == 0:
            return
        pool_eps, succ, trials = self._pool_arrays()
        st = self._state
        w, x, _ = rj.waste_free_rejuvenate_binomial(
            self.model, self.prior, self.generator, st.weights,
            st.locations, succ, trials, pool_eps, self.waste_free_stages,
            proposal_scale=self._fixed_proposal_scale(),
            canonicalize=self.mcmc_canonicalize,
            kernel=self.waste_free_kernel,
            lw_seed_a=self.waste_free_lw_seed, beta=self.waste_free_beta)
        self._state = dataclasses.replace(
            st, weights=w, locations=x, just_resampled=True,
            resample_count=st.resample_count + 1)
        self._on_resample_diagnostics(st, self._state)

    def _fixed_proposal_scale(self):
        return (2.38 if self.mcmc_proposal_scale is None
                else self.mcmc_proposal_scale)

    def _rejuvenate_now(self):
        """``n_mcmc_moves`` Metropolis sweeps targeting prior × record
        likelihood, after a resample; nothing before the first committed
        experiment. The adapted scale and the mean acceptance come to the
        host once per call, and every call appends its acceptance to
        ``mcmc_acceptance_record``, in batch updates too."""
        if self._n_record == 0:
            return
        if self.compress_mcmc_record:
            pool_eps, succ, trials = self._pool_arrays()
            record = (succ, trials, pool_eps)
            fixed = rj.mcmc_rejuvenate_binomial
            adaptive = rj.mcmc_rejuvenate_binomial_adaptive
        else:
            outs, eps_rec = self._record_arrays()
            record = (outs, eps_rec, torch.ones(
                outs.shape[0], dtype=torch.bool, device=self.device))
            fixed, adaptive = rj.mcmc_rejuvenate, rj.mcmc_rejuvenate_adaptive
        st = self._state
        if self._use_adaptive_kernel:
            x, acc, ls, t = adaptive(
                self.model, self.prior, self.generator, st.locations,
                *record, self.n_mcmc_moves, self._mcmc_log_scale,
                self._mcmc_adapt_t, method=self.mcmc_method,
                target_accept=self.mcmc_target_accept,
                canonicalize=self.mcmc_canonicalize, adapt=self.mcmc_adapt)
            self._mcmc_log_scale = float(ls)
            self._mcmc_adapt_t = int(t)
        else:
            x, acc = fixed(
                self.model, self.prior, self.generator, st.locations,
                *record, self.n_mcmc_moves,
                proposal_scale=self._fixed_proposal_scale(),
                canonicalize=self.mcmc_canonicalize)
        self.mcmc_acceptance_record.append(float(acc))
        self._state = dataclasses.replace(st, locations=x)

    # -- adaptivity scores -------------------------------------------------

    def hypothetical_update(self, outcomes, expparams,
                            return_likelihood=False,
                            return_normalization=False):
        """Posterior weights that each (outcome, experiment) pair would
        give, without committing: ``(n_outcomes, n_expparams, n_particles)``,
        with the likelihood table ``(n_outcomes, n_particles, n_expparams)``
        and the normalizations ``(n_outcomes, n_expparams)`` on request."""
        eps = self.model.canonicalize_expparams(expparams, self.device)
        outcomes = torch.as_tensor(outcomes, device=self.device)
        if outcomes.ndim == 0:
            outcomes = outcomes.reshape(1)
        with self._engine_count(outcomes.shape[0] * self.n_particles
                                * n_expparams(eps)):
            norm_w, L, norms = _hypothetical_update(
                self.model, self._state.weights, self._state.locations,
                outcomes, eps, self._design_generator)
        out = (norm_w,)
        if return_likelihood:
            out = out + (L,)
        if return_normalization:
            out = out + (norms,)
        return out[0] if len(out) == 1 else out

    def _score_candidates(self, score_fn, expparams, extra_args,
                          candidate_chunk):
        """The batched design scorers' common path (:func:`score_candidates`):
        one score per candidate experiment, on the device, with no
        device→host copy."""
        eps = self.model.canonicalize_expparams(expparams, self.device)
        with self._engine_count(self.model.n_outcomes(eps)
                                * self.n_particles * n_expparams(eps)):
            return score_candidates(score_fn, self.model, self._state.weights,
                                    self._state.locations, eps, extra_args,
                                    candidate_chunk, self._design_generator)

    def bayes_risk(self, expparams, candidate_chunk=None):
        """Expected posterior Q-loss of each candidate experiment;
        ``candidate_chunk`` bounds the peak memory of a large pool."""
        return self._score_candidates(_bayes_risk, expparams, (self.model.Q,),
                                      candidate_chunk)

    def expected_information_gain(self, expparams, candidate_chunk=None):
        """Expected information gain (mutual information, nats) of each
        candidate experiment; ``candidate_chunk`` bounds the peak memory of
        a large pool."""
        return self._score_candidates(_expected_information_gain, expparams,
                                      (), candidate_chunk)

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

    def est_meanfn(self, fn):
        """Posterior mean of ``fn``, which maps one (d,) location to a
        tensor or a tuple, list or dict of them (vectorized with
        :func:`torch.func.vmap`)."""
        return particle_meanfn(self._state.weights, self._state.locations,
                               fn)

    def est_entropy(self):
        """Entropy −Σ wᵢ log wᵢ of the particle weights (0-d tensor)."""
        return _entropy(self._state.weights)

    def est_kl_divergence(self, other, kernel_bandwidth=None):
        """KL divergence D(self ‖ other) between two particle posteriors,
        through Gaussian kernel density estimates (bandwidth by Silverman's
        rule on ``other``'s covariance unless given), a block of at most
        2²² (block, n, d) differences at a time (0-d tensor)."""
        return _kl_divergence(self._state.weights, self._state.locations,
                              other.particle_weights,
                              other.particle_locations, kernel_bandwidth)

    def sample(self, n=1, generator=None):
        """``n`` particles drawn ∝ their weights, on the updater's
        generator unless one is given: (n, d)."""
        g = self.generator if generator is None else generator
        idx = torch.multinomial(torch.clamp_min(self._state.weights, EPS), n,
                                replacement=True, generator=g)
        return self._state.locations[idx]

    def posterior_distribution(self):
        """The current posterior as a :class:`~qinfer_tpu_torch.
        distributions.ParticleDistribution` (a warm start for another
        updater)."""
        return ParticleDistribution(self._state.locations,
                                    self._state.weights)

    # -- region estimation -------------------------------------------------

    def est_credible_region(self, level=0.95, return_outside=False,
                            modelparam_slice=None):
        """The smallest set of particles that holds ``level`` of the
        posterior mass: sorted by weight on the device (a stable
        descending sort, so equal weights keep their index order, as the
        JAX package's ``argsort(-w)``), the mass summed in float64 on the
        host. Returns the (k, d) NumPy points (and the rest with
        ``return_outside``)."""
        w = self._state.weights
        x = self._state.locations
        if modelparam_slice is not None:
            x = x[:, modelparam_slice]
        sorted_w, order = torch.sort(w, descending=True, stable=True)
        cmass = np.cumsum(sorted_w.cpu().numpy().astype(np.float64))
        k = min(int(np.searchsorted(cmass, level)) + 1, w.shape[0])
        x_sorted = x[order].cpu().numpy()
        if return_outside:
            return x_sorted[:k], x_sorted[k:]
        return x_sorted[:k]

    def region_est_hull(self, level=0.95, modelparam_slice=None):
        """The credible set's convex hull: ``(vertices, hull)``, the hull a
        ``scipy.spatial.ConvexHull`` (``(endpoints, None)`` in one
        dimension)."""
        from scipy.spatial import ConvexHull

        pts = self.est_credible_region(level,
                                       modelparam_slice=modelparam_slice)
        if pts.shape[1] == 1:
            return np.array([[pts.min()], [pts.max()]]), None
        hull = ConvexHull(pts)
        return pts[hull.vertices], hull

    def region_est_ellipsoid(self, level=0.95, tol=1e-4,
                             modelparam_slice=None):
        """The minimum-volume ellipsoid around the credible hull: ``(A,
        c)``, the ellipsoid {x : (x−c)ᵀ A (x−c) ≤ 1}."""
        vertices, _ = self.region_est_hull(
            level, modelparam_slice=modelparam_slice)
        return mvee(vertices, tol=tol)

    def in_credible_region(self, points, level=0.95, modelparam_slice=None,
                           method="hpd_hull", tol=1e-4):
        """Whether each point lies in the credible region: ``'hpd_hull'``
        (inside the credible set's hull, by Delaunay), ``'hpd_mvee'``
        (inside the hull's MVEE) or ``'est_cov'`` (inside the covariance
        ellipsoid scaled to ``level`` by the chi-square quantile)."""
        points = np.atleast_2d(np.asarray(points))
        if method == "est_cov":
            from scipy.stats import chi2

            x = self._state.locations
            if modelparam_slice is not None:
                x = x[:, modelparam_slice]
            mu, cov = weighted_moments(self._state.weights, x)
            scale = chi2.ppf(level, df=x.shape[1])
            return in_ellipsoid(points, scale * cov.cpu().numpy(),
                                mu.cpu().numpy())
        if method == "hpd_hull":
            from scipy.spatial import Delaunay

            pts = self.est_credible_region(
                level, modelparam_slice=modelparam_slice)
            if pts.shape[1] == 1:
                return ((points[:, 0] >= pts.min())
                        & (points[:, 0] <= pts.max()))
            return Delaunay(pts).find_simplex(points) >= 0
        if method == "hpd_mvee":
            A, c = self.region_est_ellipsoid(
                level, tol=tol, modelparam_slice=modelparam_slice)
            # mvee's A is the inverse of in_ellipsoid's shape matrix
            return in_ellipsoid(points, np.linalg.inv(A), c)
        raise ValueError(f"unknown method {method!r}")

    def posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                           range_min=None, range_max=None):
        """Weighted-histogram estimate of one parameter's marginal density:
        ``(bin centers, density)``, NumPy; ``smoothing`` is a Gaussian
        filter's width in bins."""
        w = self._state.weights.cpu().numpy()
        x = self._state.locations[:, idx_param].cpu().numpy()
        lo = range_min if range_min is not None else x.min()
        hi = range_max if range_max is not None else x.max()
        if hi <= lo:
            hi = lo + 1e-6
        hist, edges = np.histogram(x, bins=res, range=(lo, hi), weights=w,
                                   density=True)
        centers = 0.5 * (edges[1:] + edges[:-1])
        if smoothing > 0:
            from scipy.ndimage import gaussian_filter1d

            hist = gaussian_filter1d(hist, smoothing)
        return centers, hist

    # -- cluster estimators (host, scikit-learn) ----------------------------

    def _host_cloud(self):
        return (self._state.weights.cpu().numpy(),
                self._state.locations.cpu().numpy())

    def est_cluster_moments(self, cluster_opts=None):
        """Yield ``(label, weight mass, mean, cov)`` for each DBSCAN cluster
        of a host copy of the particle cloud
        (:func:`~qinfer_tpu_torch.clustering.particle_clusters` with
        ``cluster_opts``), the moments of the cluster's renormalized
        weights; clusters of zero mass are skipped."""
        from .clustering import particle_clusters

        w, x = self._host_cloud()
        for label, mask in particle_clusters(x, w, **(cluster_opts or {})):
            cw = w[mask]
            mass = cw.sum()
            if mass <= 0:
                continue
            mu, cov = weighted_moments(torch.from_numpy(cw / mass),
                                       torch.from_numpy(x[mask]))
            yield label, float(mass), mu.numpy(), cov.numpy()

    def est_cluster_covs(self, cluster_opts=None):
        """Yield ``(label, weight mass, cov)`` for each cluster."""
        for label, mass, _, cov in self.est_cluster_moments(cluster_opts):
            yield label, mass, cov

    def est_cluster_metrics(self, cluster_opts=None):
        """Summary of the clustering: ``n_clusters`` (zero-mass clusters
        count), ``n_noise`` (the NUMBER of noise particles) and
        ``weight_in_clusters``."""
        from .clustering import NO_CLUSTER, particle_clusters

        w, x = self._host_cloud()
        n_clusters, n_noise, weight_in = 0, 0, 0.0
        for label, mask in particle_clusters(x, w, **(cluster_opts or {})):
            if label == NO_CLUSTER:
                n_noise += int(mask.sum())
            else:
                n_clusters += 1
                weight_in += float(w[mask].sum())
        return {"n_clusters": n_clusters, "n_noise": n_noise,
                "weight_in_clusters": weight_in}

    # -- plots (host, matplotlib) -------------------------------------------

    def plot_posterior_marginal(self, idx_param=0, res=100, smoothing=0.0,
                                range_min=None, range_max=None,
                                label_xaxis=True, other_plot_args=None):
        """Plot one parameter's marginal (:meth:`posterior_marginal`) on the
        current axes; returns the line."""
        import matplotlib.pyplot as plt

        xs, ys = self.posterior_marginal(idx_param, res, smoothing,
                                         range_min, range_max)
        line, = plt.plot(xs, ys, **(other_plot_args or {}))
        if label_xaxis:
            plt.xlabel(self.model.modelparam_names[idx_param])
        plt.ylabel("posterior density")
        return line

    def plot_covariance(self, corr=False, param_slice=None, tick_labels=None,
                        tick_params=None):
        """Heat map of the posterior covariance (or correlation) matrix,
        optionally of the parameters ``param_slice`` (a slice or index
        list) picks; returns the image."""
        import matplotlib.pyplot as plt

        cov = self.est_covariance_mtx(corr=corr).cpu().numpy()
        names = (list(tick_labels) if tick_labels is not None
                 else list(self.model.modelparam_names))
        if param_slice is not None:
            idx = np.arange(len(names))[param_slice]
            cov = cov[np.ix_(idx, idx)]
            names = [names[i] for i in idx]
        im = plt.imshow(cov, interpolation="nearest", cmap="RdBu_r")
        plt.colorbar(im)
        plt.xticks(range(len(names)), names, **(tick_params or {}))
        plt.yticks(range(len(names)), names, **(tick_params or {}))
        return im

    # -- display -----------------------------------------------------------

    def __repr__(self):
        return (f"<SMCUpdater n_particles={self.n_particles} "
                f"n_ess={self.n_ess:.1f} "
                f"resample_count={self.resample_count}>")

    def _repr_html_(self):
        """Notebook display: the run's size and a table of each parameter's
        posterior mean ± sd."""
        from .utils import format_uncertainty

        mean = self.est_mean().cpu().numpy()
        std = np.sqrt(np.clip(np.diag(
            self.est_covariance_mtx().cpu().numpy()), 0, None))
        rows = "".join(
            f"<tr><td>{name}</td><td>{format_uncertainty(m, s)}</td></tr>"
            for name, m, s in zip(self.model.modelparam_names, mean, std))
        return ("<strong>SMCUpdater</strong> "
                f"({self.n_particles} particles, "
                f"ESS {self.n_ess:.1f}, {self.resample_count} resamples, "
                f"{len(self.data_record)} experiments)"
                f"<table><tr><th>parameter</th><th>posterior</th></tr>"
                f"{rows}</table>")


class SMCUpdaterBCRB(SMCUpdater):
    """An updater that also accumulates the Bayesian information matrix
    and so the Bayesian Cramér-Rao bound. It needs a
    :class:`~qinfer_tpu_torch.abstract_model.DifferentiableModel`: before
    each update, the Fisher information of the experiment, averaged over
    the current posterior (``adaptive=True``) or the prior ensemble drawn
    at construction, is added to ``current_bim`` (float64, host).
    ``current_bcrb`` is its pseudo-inverse. The prior's term comes from its
    ``grad_log_pdf`` (E[∇log π ∇log πᵀ] over the ensemble; zero for a
    prior without one) unless ``initial_bim`` is given. Other arguments
    are :class:`SMCUpdater`'s, the card by default.
    """

    def __init__(self, model, n_particles, prior, adaptive=False,
                 initial_bim=None, **kwargs):
        if not isinstance(model, DifferentiableModel):
            raise ValueError("SMCUpdaterBCRB requires a DifferentiableModel")
        super().__init__(model, n_particles, prior, **kwargs)
        self.adaptive = bool(adaptive)
        self._initial_weights = self._state.weights
        self._initial_locations = self._state.locations
        self._current_bim = np.asarray(
            self._prior_bim() if initial_bim is None else initial_bim,
            dtype=np.float64)

    def _prior_bim(self):
        d = self.model.n_modelparams
        glp = getattr(self.prior, "grad_log_pdf", None)
        if glp is None:
            return np.zeros((d, d))
        g = torch.as_tensor(glp(self._state.locations))
        g = torch.atleast_2d(g).expand(-1, d)
        w = self._state.weights
        return torch.einsum("n,ni,nj->ij", w, g, g).cpu().numpy()

    @property
    def current_bim(self):
        """The accumulated Bayesian information matrix, (d, d) float64."""
        return self._current_bim

    @property
    def current_bcrb(self):
        """pinv(BIM): the Bayesian Cramér-Rao bound on the posterior
        covariance. The pseudo-inverse, since the BIM is singular until
        the experiments identify every parameter when the prior adds
        nothing."""
        return np.linalg.pinv(self._current_bim)

    def update(self, outcome, expparams, check_for_resample=True):
        eps = self.model.canonicalize_expparams(expparams, self.device)
        if n_expparams(eps) != 1:
            # only the first experiment is consumed, as in SMCUpdater:
            # no Fisher information of the columns it drops
            eps = expparams_at(eps, 0)
        if self.adaptive:
            w, locs = self._state.weights, self._state.locations
        else:
            w, locs = self._initial_weights, self._initial_locations
        fi = self.model.fisher_information(locs, eps)  # (d, d, n, 1)
        self._current_bim = self._current_bim + torch.einsum(
            "ijnE,n->ij", fi, w).cpu().numpy().astype(np.float64)
        super().update(outcome, eps, check_for_resample=check_for_resample)
