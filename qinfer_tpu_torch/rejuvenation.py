"""Resample-move rejuvenation (counterpart of :mod:`qinfer_tpu.rejuvenation`).

After a resample, a few Metropolis-Hastings sweeps move every particle
under the exact posterior

    π_t(θ) ∝ prior(θ) · Π_{k ≤ t} L(o_k | θ, e_k),

which restores the diversity that Liu-West shrinkage alone loses in high
dimension (Gilks and Berzuini; Chopin 2002). The record enters in one of
two forms: the full record (every outcome and experiment) or, when every
experiment comes from a finite pool and outcomes are Bernoulli bits or
binomial counts, the per-candidate success and trial totals, which give
the same log-likelihood up to a constant that cancels in every ratio.

Kernels: fixed-scale random walk (:func:`mcmc_rejuvenate`,
:func:`mcmc_rejuvenate_binomial`), the adaptive random walk and MALA with
Robbins-Monro step-size adaptation (:func:`mcmc_rejuvenate_adaptive`,
:func:`mcmc_rejuvenate_binomial_adaptive`) and waste-free resample-move
(:func:`waste_free_rejuvenate_binomial`, :func:`waste_free_rejuvenate`).
The sweeps run as a Python loop on the caller's :class:`torch.Generator`;
locations, log-posteriors, acceptances and the adapted scale stay on the
particles' device, and each call synchronizes with the host once for its
proposal factor (a Cholesky that may fail), and once more to group a full
record by outcome.

Every kernel takes ``mesh``: an ensemble sharded over a
:class:`~qinfer_tpu_torch.parallel.ParticleMesh` draws its per-particle
values (proposal noise, uniforms, a keyed likelihood's noise) from its
shards' own streams (:class:`~qinfer_tpu_torch.parallel.mesh.
ParticleStreams`), so a mesh across processes draws what a one-process
mesh of the same D draws, while the replicated draws (the waste-free
offset, a keyed likelihood's common-random-number seed) stay on the
caller's generator. Across processes each rank moves its own block, and
the ensemble's moments and each sweep's acceptance are the ranks'
partials summed over the group; waste-free chains run on the rank that
owns their seeds' slots. Without a mesh the draws and sums are the
unsharded ones, bit for bit.
"""

from __future__ import annotations

import math

import torch

from . import tracing
from .abstract_model import keyed_kwargs, per_particle
from .derived_models import BinomialModel
from .parallel.mesh import LOCAL, particle_streams, reducer_of
from .resamplers import counting_multiplicities_from_u
from .utils import cumsum_last, sqrtm_psd

__all__ = ["resolve_prior_log_pdf", "record_log_likelihood",
           "binomial_record_log_likelihood",
           "mcmc_rejuvenate", "mcmc_rejuvenate_binomial",
           "mcmc_rejuvenate_adaptive", "mcmc_rejuvenate_binomial_adaptive",
           "initial_log_scale", "default_target_accept",
           "waste_free_rejuvenate", "waste_free_rejuvenate_binomial"]

#: floor for linear likelihoods before the log (exact zeros would make the
#: MH ratio −inf − −inf = NaN when both states are impossible). 1e-37, not
#: 1e-38: the latter is subnormal in float32, and a backend that flushes
#: subnormals to zero (XLA on the CPU does) turns its log into −inf and
#: the floor into a no-op.
_LL_FLOOR = 1e-37
#: the same floor in log space, computed on the host in float64
_LOG_LL_FLOOR = -85.19565
#: record steps a full-record likelihood call takes at once
_RECORD_CHUNK = 256


def resolve_prior_log_pdf(prior):
    """The prior log-density of the MH target.

    A ``log_pdf`` method if the distribution has one; otherwise
    ``is_flat_on_support`` means a density constant on its support
    (full-rank Ginibre and BCSZ, whose support ``model.are_models_valid``
    enforces), which adds 0 to every log-ratio. Raises ``ValueError`` for
    a prior with neither, and for a ``log_pdf`` that fails on one
    ``(1, n_rvs)`` point: moves against an intractable prior would target
    the wrong posterior.
    """
    fn = getattr(prior, "log_pdf", None)
    if fn is not None:
        n_rvs = int(getattr(prior, "n_rvs", 0) or 0)
        if n_rvs > 0:
            try:
                fn(torch.zeros((1, n_rvs)))
            except Exception as exc:
                raise ValueError(
                    f"prior {type(prior).__name__}.log_pdf cannot be "
                    "evaluated; MCMC rejuvenation (n_mcmc_moves > 0) needs "
                    "a tractable prior density") from exc
        return fn
    if getattr(prior, "is_flat_on_support", False):
        return lambda x: torch.zeros(x.shape[0], dtype=x.dtype,
                                     device=x.device)
    raise ValueError(
        f"prior {type(prior).__name__} supports neither log_pdf nor "
        "is_flat_on_support; MCMC rejuvenation (n_mcmc_moves > 0) needs a "
        "tractable prior density")


def _record_groups(outcomes, eps_record, mask):
    """The observed record steps grouped by outcome value (a scalar, or a
    whole count vector for vector outcomes), in chunks of at most
    ``_RECORD_CHUNK`` steps: ``[(outcome (1,) or (1, k), expparams of the
    chunk's steps)]``. One host synchronization (the outcomes and the
    mask)."""
    outcomes = torch.as_tensor(outcomes)
    mask = torch.as_tensor(mask, device=outcomes.device).to(torch.bool)
    host = outcomes.reshape(outcomes.shape[0], -1).cpu().tolist()
    keep = mask.cpu().tolist()
    by_value = {}
    for k, (v, m) in enumerate(zip(host, keep)):
        if m:
            by_value.setdefault(tuple(v), []).append(k)
    groups = []
    for steps in by_value.values():
        for c in range(0, len(steps), _RECORD_CHUNK):
            idx = torch.tensor(steps[c:c + _RECORD_CHUNK],
                               device=outcomes.device)
            groups.append((outcomes[idx[:1]],
                           {k: v[idx] for k, v in eps_record.items()}))
    return groups


def _grouped_log_likelihood(model, locations, groups, generator=None):
    """Σ over the record of log L(o_k | θ, e_k): (n,). The log path where
    the model has a stable log-likelihood (floored at ``_LOG_LL_FLOOR``),
    else the linear likelihood floored at ``_LL_FLOOR``. A keyed model
    (``wants_likelihood_key``) draws its noise from ``generator``."""
    use_log = bool(getattr(model, "has_log_likelihood", False))
    kw = keyed_kwargs(model, generator)
    total = torch.zeros(locations.shape[0], dtype=locations.dtype,
                        device=locations.device)
    for outcome, eps in groups:
        if use_log:
            ll = model.log_likelihood(outcome, locations, eps, **kw)[0]
            # exact −inf (impossible outcomes) floored like the linear
            # path: the MH ratio must never see −inf minus −inf
            ll = torch.clamp_min(ll, _LOG_LL_FLOOR)
        else:
            ll = torch.log(torch.clamp_min(
                model.likelihood(outcome, locations, eps, **kw)[0],
                _LL_FLOOR))
        total = total + ll.sum(dim=1)
    return total


def record_log_likelihood(model, locations, outcomes, eps_record, mask,
                          generator=None):
    """Σ_k mask_k · log L(o_k | θ, e_k) for every particle: (n,).

    ``outcomes`` has leading axis T (record steps); ``eps_record`` is an
    expparams dict whose fields have leading axis T (one experiment a
    step); ``mask`` (T,) selects the steps observed so far. The steps are
    grouped by outcome value, so each likelihood call takes one outcome
    and up to ``_RECORD_CHUNK`` experiments: (n, ≤ 256) at a time, never
    the (T, n, T) table of all outcomes under all experiments. A keyed
    model draws its noise from ``generator``.
    """
    return _grouped_log_likelihood(
        model, locations, _record_groups(outcomes, eps_record, mask),
        generator)


def binomial_record_log_likelihood(two_outcome_model, locations, succ,
                                   trials, eps_pool):
    """The record log-likelihood from per-candidate sufficient statistics.

    When every recorded experiment comes from a finite candidate pool and
    outcomes are Bernoulli bits or binomial counts,

        Σ_k log Binom(o_k; m_k, p_{c_k}(θ))
          = Σ_e [ S_e · log p_e(θ) + (N_e − S_e) · log(1 − p_e(θ)) ] + C,

    with ``S_e`` the successes and ``N_e`` the trials at candidate e, and C
    (the log-binomial coefficients) independent of θ. One (n, E)
    likelihood pass and two matrix-vector products replace the O(T·n)
    record pass. ``succ`` and ``trials`` are (E,) totals (int32 from the
    engine; cast at use); rows with zero trials add exactly 0. Both
    outcome probabilities are floored at ``_LL_FLOOR`` independently, so
    an impossible observation costs log(_LL_FLOOR) ≈ −85 per trial: never
    less than the full record's −85 per step.

    :param two_outcome_model: the two-outcome model (success := outcome
        0, ``BinomialModel``'s convention), not the ``BinomialModel``.
    :return: (n,) record log-likelihood up to the constant C.
    """
    zero = torch.zeros((1,), dtype=torch.int32, device=locations.device)
    L0 = two_outcome_model.likelihood(zero, locations, eps_pool)[0]  # (n, E)
    p0 = torch.clamp(L0, _LL_FLOOR, 1.0)
    q0 = torch.clamp(1.0 - L0, _LL_FLOOR, 1.0)
    return (torch.log(p0) @ succ.to(p0.dtype)
            + torch.log(q0) @ (trials - succ).to(q0.dtype))


def _reducer(mesh):
    return LOCAL if mesh is None else reducer_of(mesh.particle_sharding)


def _mean(flags, reducer=LOCAL):
    """The mean of a per-particle flag over the whole ensemble: this
    process's count and the ranks' summed over a mesh across processes."""
    f = flags.to(torch.float32)
    if reducer is LOCAL:
        return f.mean()
    return reducer.sum(f.sum()) / (f.shape[0] * reducer.n_shards)


def _ensemble_chol(locations, weights=None, reducer=LOCAL):
    """Cholesky factor of the (optionally weighted) ensemble covariance
    plus 1e-10·I, or its PSD square root where the Cholesky fails (a
    failed pivot or a NaN factor). Synchronizes with the host once. Over
    a mesh across processes (``reducer``), the mean's and the outer
    products' sums are this rank's partials, summed over the ranks; every
    rank then holds the same covariance and reaches the same verdict."""
    n, d = locations.shape
    if weights is None:
        if reducer is LOCAL:
            mu = locations.mean(dim=0)
        else:
            n = n * reducer.n_shards
            mu = reducer.sum(locations.sum(dim=0)) / n
        xc = locations - mu[None, :]
        cov = reducer.sum(xc.T @ xc) / n
    else:
        mu = reducer.sum(weights @ locations)
        xc = locations - mu[None, :]
        cov = reducer.sum((weights[:, None] * xc).T @ xc)
    cov = cov + 1e-10 * torch.eye(d, dtype=locations.dtype,
                                  device=locations.device)
    chol, info = torch.linalg.cholesky_ex(cov)
    tracing.host_read("moves.chol_verdict")
    if bool((info != 0) | torch.isnan(chol).any()):
        return sqrtm_psd(cov)
    return chol


def _two_outcome(model):
    return (model.underlying_model if isinstance(model, BinomialModel)
            else model)


def _refuse_keyed(model, what):
    """``ValueError`` for a Monte-Carlo likelihood
    (``wants_likelihood_key``) on a path that needs a deterministic one."""
    if getattr(model, "wants_likelihood_key", False):
        raise ValueError(f"{what} requires a deterministic likelihood "
                         "(wants_likelihood_key models re-estimate per "
                         "evaluation)")


def _normal(generator, like):
    """Standard normals of ``like``'s shape, a row a particle, from a
    generator or a sharded ensemble's streams."""
    return per_particle(generator, lambda g, x: torch.randn(
        x.shape, generator=g, device=x.device, dtype=x.dtype), like)


def _log_uniform(generator, like):
    """log U[0, 1), one a particle (a row of ``like``)."""
    return torch.log(per_particle(generator, lambda g, x: torch.rand(
        (x.shape[0],), generator=g, device=x.device, dtype=x.dtype), like))


def mcmc_rejuvenate(model, prior, generator, locations, outcomes,
                    eps_record, mask, n_moves, proposal_scale=2.38,
                    canonicalize=True, mesh=None):
    """``n_moves`` random-walk Metropolis sweeps of every particle under
    prior × the masked full record's likelihood
    (:func:`record_log_likelihood`).

    Proposal: Gaussian with covariance ``(proposal_scale² / d)·Σ`` of the
    ensemble (Roberts, Gelman and Gilks), so the walk follows the
    posterior's current shape, near-degenerate constrained directions
    included. Proposals outside ``model.are_models_valid`` are rejected
    (the prior's support). ``canonicalize=False`` skips the final
    ``model.canonicalize``: every accepted proposal passed the validity
    check, so the ensemble stays within the model's tolerance. This is the
    adaptive kernel's random walk with the scale held fixed.

    :param mesh: the mesh of a sharded ensemble (``locations`` this
        process's rows), see the module.
    :return: ``(new_locations, mean_acceptance)``, the latter a 0-d
        tensor.
    """
    groups = _record_groups(outcomes, eps_record, mask)
    return _fixed_scale(
        model, prior, generator, locations,
        lambda x, g=None: _grouped_log_likelihood(model, x, groups, g),
        n_moves, proposal_scale, canonicalize, mesh)


def mcmc_rejuvenate_binomial(model, prior, generator, locations, succ,
                             trials, eps_pool, n_moves, proposal_scale=2.38,
                             canonicalize=True, mesh=None):
    """Sufficient-statistic twin of :func:`mcmc_rejuvenate`: the same
    target up to a constant, each evaluation one (n, E) pool pass.
    ``model`` may be a ``BinomialModel`` (unwrapped for the success
    probability) or the bare two-outcome model; validity and
    canonicalization use ``model`` itself. A Monte-Carlo likelihood is
    refused (``ValueError``): the totals cannot reproduce each step's
    noise."""
    two = _two_outcome(model)
    _refuse_keyed(two, "sufficient-statistic rejuvenation")
    return _fixed_scale(
        model, prior, generator, locations,
        lambda x: binomial_record_log_likelihood(two, x, succ, trials,
                                                 eps_pool),
        n_moves, proposal_scale, canonicalize, mesh)


def _fixed_scale(model, prior, generator, locations, record_ll, n_moves,
                 proposal_scale, canonicalize, mesh=None):
    x, acc, _, _ = _mh_moves_adaptive(
        model, prior, generator, locations, record_ll, n_moves,
        initial_log_scale(locations.shape[1], "rwm", proposal_scale), 0,
        "rwm", 0.0, canonicalize, adapt=False, mesh=mesh)
    return x, acc


# ---------------------------------------------------------------------------
# Waste-free resample-move (Dau and Chopin 2022)
# ---------------------------------------------------------------------------


def _counting_ancestors(u, weights, n_out):
    """Sorted systematic ancestors (n_out,) with uniform offset ``u``: the
    counting multiplicities expanded by ``repeat_interleave`` (K3's
    contract is n rows out, and here n_out = n / P)."""
    m, _ = counting_multiplicities_from_u(u, weights, n_out)
    return torch.repeat_interleave(
        torch.arange(weights.shape[0], device=weights.device), m,
        output_size=n_out)


def _sharded_seeds(u, weights, locations, n_seeds, mesh):
    """The waste-free seeds of this process's chains on ``mesh``: the
    ``n_seeds`` = M systematic ancestors of the whole ensemble at offset
    ``u``, each shard counting its own particles' slots from its offset in
    the global CDF (the exclusive prefix of the shards' weight totals, all
    gathered), so the slots of all shards are exactly M; the seeds,
    gathered in global slot order; and this process's shards' chains, M/D
    a shard, shard s running slots ``[s·M/D, (s+1)·M/D)``: (L·M/D, d)."""
    D, M = mesh.n_devices, n_seeds
    w = mesh.shard(weights)
    x = mesh.shard(locations)
    L, k, d = x.shape
    dev = x.device
    totals = mesh.all_gather(w.sum(dim=1))
    ends = torch.cumsum(totals, 0)
    W = torch.clamp_min(ends[-1], 1e-30)
    starts = ends - totals
    # slots before each shard's start, then before each particle's end
    bound = torch.ceil(M * torch.clamp_max(starts / W, 1.0) - u)
    bound = torch.cat([torch.clamp(bound, 0.0, float(M)),
                       torch.full((1,), float(M), device=dev)])
    bound = torch.cummax(bound, dim=0).values
    idx = mesh.axis_index(dev)
    lo, hi = bound[idx][:, None], bound[idx + 1][:, None]
    local = cumsum_last(w)
    cdf = torch.clamp_max((starts[idx][:, None] + local) / W, 1.0)
    # a particle whose prefix reached its shard's total ends the shard's
    # slots (so the slots float32 drops go to the last particle of
    # positive weight, as the one-ensemble counting pass gives them)
    reached = local >= local[:, -1:]
    reached[:, -1] = True
    upper = torch.where(reached, hi, torch.clamp(torch.ceil(M * cdf - u),
                                                 lo, hi))
    upper = torch.cummax(upper, dim=1).values.to(torch.int64)
    # slot j of shard s's range takes the first particle whose upper
    # count passes j; the shard's own slots, at their global rows
    slots = torch.arange(M, device=dev).expand(L, M).contiguous()
    anc = torch.clamp_max(torch.searchsorted(upper, slots, right=True), k - 1)
    mine = (slots >= lo) & (slots < hi)
    rows = torch.where(mine[..., None], torch.gather(
        x, 1, anc[..., None].expand(L, M, d)), 0.0)
    every = mesh.all_gather(rows)
    owner = torch.searchsorted(bound[1:].contiguous(),
                               torch.arange(M, dtype=bound.dtype,
                                            device=dev), right=True)
    seeds = every[torch.clamp_max(owner, D - 1), torch.arange(M, device=dev)]
    per = M // D
    return torch.cat([seeds[s * per:(s + 1) * per]
                      for s in mesh.shard_indices])


@torch.no_grad()
def _waste_free_core(model, prior, generator, weights, locations, record_ll,
                     n_stages, proposal_scale, canonicalize, kernel="rwm",
                     lw_seed_a=None, beta=0.3, mesh=None):
    """Waste-free resample-move: M = n/P systematic ancestors, P − 1
    Metropolis steps from each, and every chain state kept as a particle
    with uniform weight (each state is marginally posterior-distributed).
    The proposal covariance is the full weighted ensemble's.

    * ``lw_seed_a``: perturb the ancestors with one Liu-West step
      ``a·x + (1 − a)·μ + h·L·ξ`` (h = √(1 − a²)) before chaining; invalid
      seeds keep their ancestor.
    * ``kernel='pcn'``: preconditioned Crank-Nicolson proposals
      ``x' = μ + √(1 − β²)(x − μ) + β·L·ξ``, reversible for N(μ, Σ), so
      the ratio is the residual ``[lp(x') + ‖r'‖²/2] − [lp(x) + ‖r‖²/2]``
      with r the whitened residual (carried, so no solve after the first).

    On a ``mesh`` the M seeds are one global systematic draw at the
    replicated offset (:func:`_sharded_seeds`), shard s runs the chains
    of slots ``[s·M/D, (s+1)·M/D)`` and keeps their states as its n/D
    particles, so D must divide M (``ValueError`` otherwise).

    :return: ``(uniform weights, locations, mean acceptance)``.
    """
    n_local, d = locations.shape
    reducer = _reducer(mesh)
    n = n_local * reducer.n_shards
    P = int(n_stages)
    if n % P:
        raise ValueError(f"n_stages={P} must divide n_particles={n}")
    if kernel not in ("rwm", "pcn"):
        raise ValueError(f"unknown waste-free kernel {kernel!r} "
                         "(rwm | pcn)")
    M = n // P
    if mesh is not None and M % mesh.n_devices:
        raise ValueError(
            f"waste-free resample-move on a mesh of {mesh.n_devices} shards "
            f"runs M = n/P = {M} chains, M/D a shard: the mesh size must "
            f"divide M (choose waste_free_stages so that it does)")
    log_pdf = resolve_prior_log_pdf(prior)
    mu = reducer.sum(weights @ locations)
    chol = _ensemble_chol(locations, weights=weights, reducer=reducer)
    step = (proposal_scale / math.sqrt(d)) * chol

    u = torch.rand((), generator=generator, device=locations.device)
    if mesh is None:
        x0 = locations[_counting_ancestors(u, weights, M)]
    else:
        x0 = _sharded_seeds(u, weights, locations, M, mesh)
    draws = particle_streams(generator, mesh)
    if lw_seed_a is not None:
        a = float(lw_seed_a)
        h = math.sqrt(max(1.0 - a * a, 0.0))
        seed = (a * x0 + (1.0 - a) * mu[None, :]
                + h * _normal(draws, x0) @ chol.T)
        ok = model.are_models_valid(seed)
        x0 = torch.where(ok[:, None], seed, x0)

    def posterior_lp(x):
        return record_ll(x) + log_pdf(x)

    x, lp = x0, posterior_lp(x0)
    chain, accs = [x0], []
    if kernel == "pcn":
        beta = float(beta)
        rho = math.sqrt(1.0 - beta * beta)
        r = torch.linalg.solve_triangular(
            chol, (x0 - mu[None, :]).T, upper=False).T
    for _ in range(P - 1):
        if kernel == "pcn":
            r_p = rho * r + beta * _normal(draws, x)
            prop = mu[None, :] + r_p @ chol.T
        else:
            prop = x + _normal(draws, x) @ step.T
        valid = model.are_models_valid(prop)
        lp_p = posterior_lp(prop)
        if kernel == "pcn":
            # residual-likelihood ratio (the Gaussian reference cancels)
            ratio = ((lp_p + 0.5 * torch.sum(r_p * r_p, dim=1))
                     - (lp + 0.5 * torch.sum(r * r, dim=1)))
        else:
            ratio = lp_p - lp
        accept = valid & (_log_uniform(draws, x) < ratio)
        x = torch.where(accept[:, None], prop, x)
        lp = torch.where(accept, lp_p, lp)
        if kernel == "pcn":
            r = torch.where(accept[:, None], r_p, r)
        chain.append(x)
        accs.append(_mean(accept, reducer))
    # the ancestors and P − 1 chain states each: P·M = n particles, a
    # shard's P·M/D = n/D from its own chains
    out = torch.stack(chain)
    if mesh is not None:
        out = out.reshape(P, mesh.local_shards, -1, d).transpose(0, 1)
    out = out.reshape(n_local, d)
    if canonicalize:
        out = model.canonicalize(out)
    w = torch.full((n_local,), 1.0 / n, dtype=locations.dtype,
                   device=locations.device)
    acc = (torch.stack(accs).mean() if accs
           else torch.full((), math.nan, device=locations.device))
    return w, out, acc


def waste_free_rejuvenate_binomial(model, prior, generator, weights,
                                   locations, succ, trials, eps_pool,
                                   n_stages, proposal_scale=2.38,
                                   canonicalize=True, kernel="rwm",
                                   lw_seed_a=None, beta=0.3, mesh=None):
    """Waste-free resample-move over the sufficient-statistic record: it
    replaces both the resample and the moves, so call it instead of the
    resampler when the ESS gate fires. A Monte-Carlo likelihood is
    refused (``ValueError``)."""
    two = _two_outcome(model)
    _refuse_keyed(two, "waste-free rejuvenation")
    return _waste_free_core(
        model, prior, generator, weights, locations,
        lambda x: binomial_record_log_likelihood(two, x, succ, trials,
                                                 eps_pool),
        n_stages, proposal_scale, canonicalize, kernel=kernel,
        lw_seed_a=lw_seed_a, beta=beta, mesh=mesh)


def waste_free_rejuvenate(model, prior, generator, weights, locations,
                          outcomes, eps_record, mask, n_stages,
                          proposal_scale=2.38, canonicalize=True,
                          kernel="rwm", lw_seed_a=None, beta=0.3,
                          mesh=None):
    """Full-record waste-free resample-move (any deterministic model;
    O(T·M) per evaluation instead of O(T·n)). A Monte-Carlo likelihood is
    refused (``ValueError``): keeping every chain state as a particle
    needs the same likelihood at every evaluation."""
    _refuse_keyed(model, "waste-free rejuvenation")
    groups = _record_groups(outcomes, eps_record, mask)
    return _waste_free_core(
        model, prior, generator, weights, locations,
        lambda x: _grouped_log_likelihood(model, x, groups),
        n_stages, proposal_scale, canonicalize, kernel=kernel,
        lw_seed_a=lw_seed_a, beta=beta, mesh=mesh)


# ---------------------------------------------------------------------------
# Adaptive kernels: MALA proposals and Robbins-Monro step-size adaptation
# ---------------------------------------------------------------------------
#
# MALA drifts each proposal along ∇ log π (for the sufficient-statistic
# target, two more matrix-vector products by autograd), with optimal
# acceptance 0.574 against the random walk's 0.234 (Roberts and Rosenthal
# 1998). Robbins-Monro adaptation moves the log step size by
# γ_t · (acceptance − target) after every sweep, γ_t = γ₀/(1 + t)^κ
# floored at γ_min; over n ≈ 5·10⁴ particles a sweep's mean acceptance
# has little noise, so the scale settles within a few resample events.
#
# Everything runs in whitened coordinates y = A⁻¹x (A the ensemble
# Cholesky factor): a proposal is x' = x + (drift_w + s·ξ) @ Aᵀ, and both
# MALA proposal densities follow from the whitened displacement, known by
# construction, with no triangular solve.

#: clamp of the adapted log step size: a guard against runaway adaptation
#: when acceptance degenerates, far wider than any useful scale
_LOG_SCALE_MIN = -12.0
_LOG_SCALE_MAX = 6.0


def default_target_accept(method):
    """Optimal-scaling acceptance targets: 0.574 for MALA, 0.234 for the
    random walk (Roberts, Gelman and Gilks 1997; Roberts and Rosenthal
    1998)."""
    if method == "mala":
        return 0.574
    if method == "rwm":
        return 0.234
    raise ValueError(f"unknown MCMC method {method!r} "
                     "(expected 'rwm' or 'mala')")


def initial_log_scale(d, method="rwm", proposal_scale=None):
    """Log of the initial multiplier of the ensemble Cholesky factor:
    ``2.38/√d`` for the random walk, ``1.65·d^{−1/6}`` for MALA. A
    ``proposal_scale`` replaces the numerator; ``None`` means the
    method's constant."""
    if method == "mala":
        base = 1.65 if proposal_scale is None else float(proposal_scale)
        return math.log(base) - math.log(float(d)) / 6.0
    if method == "rwm":
        base = 2.38 if proposal_scale is None else float(proposal_scale)
        return math.log(base) - 0.5 * math.log(float(d))
    raise ValueError(f"unknown MCMC method {method!r} "
                     "(expected 'rwm' or 'mala')")


def _rm_gain(t, gain0=1.0, kappa=0.6, floor=0.05):
    """Floored Robbins-Monro gain ``max(γ₀/(1 + t)^κ, γ_min)`` of the
    sweep counter ``t`` (a tensor). The floor keeps the recursion
    tracking: a badly seeded scale recovers within tens of sweeps."""
    t = torch.as_tensor(t).to(torch.float32)
    return torch.clamp_min(gain0 / (1.0 + t) ** kappa, floor)


def _lp_and_whitened_grad(posterior_lp, x, chol, cap):
    """``(lp, u)``: the log-posterior of every particle and its gradient in
    whitened coordinates, ``u = ∇lp · A`` (∂lp/∂y for y = A⁻¹x), by
    autograd of Σ lp with respect to a leaf copy of ``x`` (each lp_i
    depends on x_i alone, so this is the per-particle gradient).
    Non-finite gradient entries become 0, and u is norm-clipped at
    ``cap``."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        lp = posterior_lp(leaf)
        (g,) = torch.autograd.grad(lp.sum(), leaf)
    g = torch.where(torch.isfinite(g), g, 0.0)
    u = g @ chol
    norm = torch.linalg.vector_norm(u, dim=1, keepdim=True)
    u = u * torch.clamp_max(cap / torch.clamp_min(norm, 1e-30), 1.0)
    return lp.detach(), u


def _adaptive_sweeps(model, generator, x, lp, u, chol, posterior_lp,
                     lp_and_grad, n_moves, log_scale, adapt_t, method,
                     target_accept, adapt, crn_seed=None, mesh=None):
    """The sweep loop of :func:`_mh_moves_adaptive`, on device tensors
    only: no value comes to the host. ``u`` is the whitened gradient at
    ``x`` (MALA; None for the random walk). With ``crn_seed`` (a
    Monte-Carlo likelihood) each sweep re-estimates both sides of the
    ratio with common random numbers, a generator seeded ``crn_seed +
    sweep`` for each (Monte Carlo within Metropolis), so no lucky estimate
    freezes into the chain; on a ``mesh`` that generator seeds the
    shards' streams. ``generator`` is the caller's, or the shards'
    streams of a sharded ensemble. Returns ``(x, summed acceptance,
    log_scale, adapt_t)``."""
    reducer = _reducer(mesh)
    acc_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    ls, t = log_scale, adapt_t
    for sweep in range(int(n_moves)):
        with tracing.span("moves.propose"):
            s = torch.exp(ls)
            xi = _normal(generator, x)
            if method == "mala":
                disp_w = 0.5 * s * s * u + s * xi   # whitened displacement
                prop = x + disp_w @ chol.T
            else:
                prop = x + s * (xi @ chol.T)
        with tracing.span("moves.posterior"):
            valid = model.are_models_valid(prop)
            if method == "mala":
                lp_p, u_p = lp_and_grad(prop)
            elif crn_seed is None:
                lp_p = posterior_lp(prop)
            else:
                g = torch.Generator(device=x.device)
                g.manual_seed(crn_seed + sweep)
                lp_p = posterior_lp(prop, particle_streams(g, mesh))
                g.manual_seed(crn_seed + sweep)
                lp = posterior_lp(x, particle_streams(g, mesh))
        if method == "mala":
            # proposal densities in whitened coordinates: the forward
            # residual is s·ξ by construction, the reverse one
            # −disp_w − drift(x')
            rev = -disp_w - 0.5 * s * s * u_p
            log_q_fwd = -0.5 * torch.sum(xi * xi, dim=1)
            log_q_rev = -(0.5 / (s * s)) * torch.sum(rev * rev, dim=1)
            ratio = lp_p + log_q_rev - lp - log_q_fwd
        else:
            ratio = lp_p - lp
        accept = valid & (_log_uniform(generator, x) < ratio)
        x = torch.where(accept[:, None], prop, x)
        lp = torch.where(accept, lp_p, lp)
        if method == "mala":
            u = torch.where(accept[:, None], u_p, u)
        acc = _mean(accept, reducer)
        acc_sum = acc_sum + acc
        if adapt:
            ls = torch.clamp(ls + _rm_gain(t) * (acc - target_accept),
                             _LOG_SCALE_MIN, _LOG_SCALE_MAX)
        t = t + 1
    return x, acc_sum, ls, t


@torch.no_grad()
def _mh_moves_adaptive(model, prior, generator, locations, record_ll,
                       n_moves, log_scale, adapt_t, method, target_accept,
                       canonicalize, adapt=True, grad_clip=20.0, mesh=None):
    """Adaptive Metropolis core: ``n_moves`` sweeps of random-walk
    ('rwm') or Langevin ('mala') proposals preconditioned by the ensemble
    covariance, the log step size moved by Robbins-Monro toward
    ``target_accept`` after every sweep.

    The step size ``s = exp(log_scale)`` multiplies the Cholesky factor
    directly (the dimension scaling lives in :func:`initial_log_scale`).
    MALA's whitened gradient (:func:`_lp_and_whitened_grad`) is
    norm-clipped at ``grad_clip·√d``: a truncated-drift MALA whose
    proposal density uses the same truncated drift, so detailed balance is
    exact (Roberts and Tweedie 1996, §4).

    ``log_scale`` and ``adapt_t`` may be numbers or 0-d device tensors;
    they come back as 0-d device tensors, for the caller to read once per
    event. On a ``mesh`` (``locations`` this process's rows) the proposal
    factor, each sweep's acceptance and so the adapted scale are the
    whole ensemble's, the same on every rank.

    :return: ``(locations, mean_acceptance, log_scale, adapt_t)``.
    """
    if method not in ("rwm", "mala"):
        raise ValueError(f"unknown MCMC method {method!r} "
                         "(expected 'rwm' or 'mala')")
    keyed = bool(getattr(model, "wants_likelihood_key", False))
    if keyed and method == "mala":
        raise ValueError("mcmc_method='mala' requires a deterministic "
                         "likelihood (Monte-Carlo likelihoods have no "
                         "usable gradient; use mcmc_method='rwm')")
    with tracing.span("moves"):
        x = locations
        d = x.shape[1]
        log_pdf = resolve_prior_log_pdf(prior)
        with tracing.span("moves.factor"):
            chol = _ensemble_chol(x, reducer=_reducer(mesh))
        cap = grad_clip * math.sqrt(d)
        log_scale = torch.as_tensor(log_scale, dtype=x.dtype, device=x.device)
        adapt_t = torch.as_tensor(adapt_t, dtype=torch.int32, device=x.device)

        def posterior_lp(xx, g=None):
            return (record_ll(xx, g) if keyed else record_ll(xx)) + log_pdf(xx)

        def lp_and_grad(xx):
            return _lp_and_whitened_grad(posterior_lp, xx, chol, cap)

        crn_seed = None
        if method == "mala":
            lp, u = lp_and_grad(x)
        elif keyed:
            # every sweep re-estimates both sides, so no initial pass; the
            # call's one extra host copy is the seed of its sweeps' streams
            lp, u = torch.zeros_like(x[:, 0]), None
            tracing.host_read("moves.crn_seed")
            crn_seed = int(torch.randint(0, 2 ** 62, (1,),
                                         generator=generator,
                                         device=x.device))
        else:
            lp, u = posterior_lp(x), None
        x, acc_sum, log_scale, adapt_t = _adaptive_sweeps(
            model, particle_streams(generator, mesh), x, lp, u, chol,
            posterior_lp, lp_and_grad, n_moves, log_scale, adapt_t, method,
            float(target_accept), adapt, crn_seed, mesh)
        if canonicalize:
            x = model.canonicalize(x)
        return x, acc_sum / max(int(n_moves), 1), log_scale, adapt_t


def mcmc_rejuvenate_adaptive(model, prior, generator, locations, outcomes,
                             eps_record, mask, n_moves, log_scale, adapt_t,
                             method="mala", target_accept=None,
                             canonicalize=True, adapt=True, mesh=None):
    """Adaptive twin of :func:`mcmc_rejuvenate`: MALA or random-walk
    proposals with Robbins-Monro adaptation on the full-record target.

    :return: ``(locations, mean_acceptance, log_scale, adapt_t)``.
    """
    if target_accept is None:
        target_accept = default_target_accept(method)
    groups = _record_groups(outcomes, eps_record, mask)
    return _mh_moves_adaptive(
        model, prior, generator, locations,
        lambda x, g=None: _grouped_log_likelihood(model, x, groups, g),
        n_moves,
        log_scale, adapt_t, method, target_accept, canonicalize,
        adapt=adapt, mesh=mesh)


def mcmc_rejuvenate_binomial_adaptive(model, prior, generator, locations,
                                      succ, trials, eps_pool, n_moves,
                                      log_scale, adapt_t, method="mala",
                                      target_accept=None, canonicalize=True,
                                      adapt=True, mesh=None):
    """Adaptive twin of :func:`mcmc_rejuvenate_binomial` on the
    sufficient-statistic target.

    :return: ``(locations, mean_acceptance, log_scale, adapt_t)``.
    """
    if target_accept is None:
        target_accept = default_target_accept(method)
    two = _two_outcome(model)
    _refuse_keyed(two, "sufficient-statistic rejuvenation")
    return _mh_moves_adaptive(
        model, prior, generator, locations,
        lambda x: binomial_record_log_likelihood(two, x, succ, trials,
                                                 eps_pool),
        n_moves, log_scale, adapt_t, method, target_accept, canonicalize,
        adapt=adapt, mesh=mesh)
