"""Particle resamplers (counterpart of :mod:`qinfer_tpu.resamplers`).

Ancestor selection is systematic resampling in its sort-free counting form:
one cumsum gives every particle's copy count ``m_i`` and first output slot,
and kernel K3 (:func:`~qinfer_tpu_torch.ops.streaming_resample.
streaming_resample_locations`) expands the survivors into their spans with
no scatter and no gather. The Liu-West resampler then draws the shrinkage
proposal, redraws invalid proposals for at most ``maxiter`` rounds and
falls back to the ancestor for slots still invalid. Its batched form
(:meth:`LiuWestResampler.call_batch_with_diagnostics`) resamples the
ensembles of several independent runs at once, with ONE K3 launch over
all their rows.

The ancestor-index functions of the JAX package are plain torch functions
here, with explicit generators: the merge-rank form
(:func:`systematic_ancestors`, by ``searchsorted``, its exact equivalent),
the counting form (:func:`counting_ancestors_from_u`,
:func:`systematic_ancestors_counting`) and iid categorical ancestors
(:func:`multinomial_ancestors`).
"""

from __future__ import annotations

import math

import torch

from .config import EPS
from .ops.streaming_resample import streaming_resample_locations
from .utils import cumsum_last, weighted_moments, sqrtm_psd

__all__ = ["Resampler", "LiuWestResampler",
           "counting_multiplicities_from_u", "counting_locations_from_u",
           "counting_locations_batch_from_u", "counting_ancestors_from_u",
           "systematic_ancestors", "systematic_resample_locations",
           "systematic_ancestors_counting",
           "systematic_resample_locations_counting", "multinomial_ancestors"]

#: largest float32 strictly below 1.0: stratified positions are clamped
#: here so that none rounds up to 1.0 and ties with the CDF's last entry
_BELOW_ONE = 1.0 - 2.0 ** -24

#: rows K3 can address: its output offsets (``starts``) are int32 row
#: indices (the word index inside the kernel is 64-bit, so d is free)
_K3_MAX_ROWS = 2 ** 31 - 1


def counting_multiplicities_from_u(u, weights, n_out):
    """Per-particle copy counts and output offsets of systematic resampling
    with uniform offset ``u``, from ONE cumsum and elementwise math.

    ``m_i = ceil(n·F_i − u) − ceil(n·F_{i−1} − u)`` counts the stratified
    positions ``(j + u)/n`` that land in ``(F_{i−1}, F_i]``; the exclusive
    cumsum of ``m`` is ``ceil(n·F_{i−1} − u)`` itself. ``n·F`` amplifies
    float32 CDF rounding, so a boundary assignment can shift by one slot
    relative to another summation order; ``Σ m = n`` holds exactly and no
    slot goes to a particle of zero weight (the JAX package's loses the
    last slot when float32 rounds ``n − u`` down: see the comment below).

    Batched: ``weights`` (T, n) with ``u`` (T,) counts each row along the
    last axis with its own offset (the clamp and the ``cummax`` per row,
    so every row keeps ``Σ m = n``).

    :param u: uniform offset in [0, 1) (number or 0-d tensor; (T,) for
        batched weights).
    :return: ``(m, offsets)``, both int32 of the weights' shape.
    """
    if torch.is_tensor(u) and u.ndim == 1:
        u = u[:, None]
    cdf = cumsum_last(weights)
    # a parallel cumsum (the GPU's) may leave a prefix an ulp above the
    # total; the clamp keeps every ceiling at or below n_out so Σ m = n_out
    cdf = torch.clamp_max(
        cdf / torch.clamp_min(cdf[..., -1:], EPS), 1.0)
    # a prefix that has reached the total has ceiling ceil(n_out − u) =
    # n_out for every u in [0, 1), but float32 rounds n_out − u down to
    # n_out − 1 when u lies within half an ulp of n_out below 1 (u > 0.996
    # at n = 2¹⁷, > 0.875 at 2²²), which would hand the last slot to the
    # last particle whatever its weight; every such ceiling is set
    # exactly, so the slot goes to the first particle whose prefix reaches
    # the total (the last one of positive weight). The last prefix counts
    # as reached even when a total below EPS leaves it short of 1.
    reached = cdf >= 1.0
    reached[..., -1] = True
    upper = torch.where(reached, float(n_out), torch.ceil(n_out * cdf - u))
    # the prefix sums can also dip by an ulp; cummax restores monotonicity
    # so no m is negative and no spans overlap
    upper = torch.cummax(upper, dim=-1).values
    lower = torch.cat([torch.zeros_like(upper[..., :1]), upper[..., :-1]],
                      dim=-1)
    m = (upper - lower).to(torch.int32)
    offsets = torch.clamp_min(lower, 0.0).to(torch.int32)
    return m, offsets


def counting_locations_from_u(u, weights, locations):
    """Systematic resample-to-locations with uniform offset ``u``: the
    counting multiplicities expanded by kernel K3. Returns (n, d)."""
    m, offsets = counting_multiplicities_from_u(
        u, weights, locations.shape[0])
    return streaming_resample_locations(m, offsets, locations)


def counting_locations_batch_from_u(u, weights, locations):
    """The counting fill of T' ensembles at once: ``weights`` (T', n),
    ``locations`` (T', n, d) and one uniform offset per ensemble, ``u``
    (T',). Each row is counted on its own
    (:func:`counting_multiplicities_from_u` along the last axis), and K3
    runs ONCE over the flattened (T'·n, d) rows with each ensemble's
    offsets shifted by t·n, so ensemble t's copies land in its own rows.
    Row t of the result is ensemble t's own fill to the bit, whatever the
    other rows hold: K3 copies raw words.

    :return: ``(x_anc (T', n, d), m (T'·n,), starts (T'·n,))``, the last
        two the flat counts and offsets K3 was given.
    :raises ValueError: when T'·n rows exceed K3's int32 offsets.
    """
    tp, n, d = locations.shape
    if tp * n > _K3_MAX_ROWS:
        raise ValueError(
            f"{tp} ensembles of {n} particles are {tp * n} rows, more than "
            f"K3's int32 output offsets address ({_K3_MAX_ROWS}); resample "
            f"fewer ensembles at once")
    m, offsets = counting_multiplicities_from_u(u, weights, n)
    shift = torch.arange(tp, dtype=torch.int32,
                         device=offsets.device)[:, None] * n
    m, starts = m.reshape(-1), (offsets + shift).reshape(-1)
    x = streaming_resample_locations(m, starts, locations.reshape(tp * n, d))
    return x.reshape(tp, n, d), m, starts


def counting_ancestors_from_u(u, weights, n_out):
    """Systematic ancestor indices of the counting form with an explicit
    uniform offset: particle i fills its ``m_i`` slots from its first
    output slot on, i.e. ``repeat(arange(n), m)`` (the JAX package
    scatters each survivor's index at its first slot and forward-fills
    with ``cummax``: the same indices). Deterministic given ``u``.

    :return: (n_out,) int32 ancestor indices, non-decreasing.
    """
    m, _ = counting_multiplicities_from_u(u, weights, n_out)
    idx = torch.arange(weights.shape[0], dtype=torch.int32,
                       device=weights.device)
    return idx.repeat_interleave(m, output_size=n_out)


def _systematic_ancestors_from_u(u, weights, n_out):
    """The merge-rank ancestors with an explicit offset: position
    ``min((j + u)/n_out, 1 − 2⁻²⁴)`` maps to the number of CDF entries at
    or below it (``searchsorted(..., right=True)``), clipped to n − 1."""
    n = weights.shape[0]
    cdf = cumsum_last(weights)
    cdf = cdf / cdf[-1]
    positions = (torch.arange(n_out, dtype=cdf.dtype, device=cdf.device)
                 + u) / n_out
    positions = torch.clamp_max(positions, _BELOW_ONE)
    anc = torch.searchsorted(cdf, positions, right=True)
    return torch.clamp(anc, 0, n - 1).to(torch.int32)


def systematic_ancestors(generator, weights, n_out=None):
    """Systematic (stratified, one-uniform) ancestor indices by inverting
    the weight CDF at the positions ``(j + u)/n``. The JAX package
    computes this by a stable merge sort of the CDF and the positions (a
    TPU has no fast ``searchsorted``); ``searchsorted`` gives the same
    indices. Kept for comparison: the engine uses the counting form.

    :return: (n_out,) int32.
    """
    n_out = weights.shape[0] if n_out is None else int(n_out)
    u = torch.rand((), generator=generator, device=weights.device)
    return _systematic_ancestors_from_u(u, weights, n_out)


def systematic_resample_locations(generator, weights, locations):
    """Systematic resampling to locations by the merge-rank ancestors:
    ``locations[systematic_ancestors(generator, weights)]``, (n, d)."""
    return locations[systematic_ancestors(generator, weights).long()]


def systematic_ancestors_counting(generator, weights, n_out=None):
    """Sort-free systematic ancestor indices
    (:func:`counting_ancestors_from_u` with one uniform drawn from
    ``generator``); the same law as :func:`systematic_ancestors`, with
    boundary slots that may differ by one particle. (n_out,) int32."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    u = torch.rand((), generator=generator, device=weights.device)
    return counting_ancestors_from_u(u, weights, n_out)


def systematic_resample_locations_counting(generator, weights, locations):
    """Sort-free systematic resampling to locations: the counting fill
    (K3) with one uniform drawn from ``generator``. (n, d)."""
    u = torch.rand((), generator=generator, device=weights.device)
    return counting_locations_from_u(u, weights, locations.contiguous())


def multinomial_ancestors(generator, weights, n_out=None):
    """IID categorical ancestor indices ∝ ``weights`` (the reference
    package's scheme), (n_out,) int64."""
    n_out = weights.shape[0] if n_out is None else int(n_out)
    return torch.multinomial(torch.clamp_min(weights, EPS), n_out,
                             replacement=True, generator=generator)


def _batched_moments(w, x):
    """Per-ensemble weighted mean (T, d) and covariance (T, d, d), the
    batched :func:`~qinfer_tpu_torch.utils.weighted_moments`."""
    mu = torch.bmm(w[:, None, :], x)[:, 0, :]
    xc = x - mu[:, None, :]
    cov = torch.bmm((xc * w[..., None]).transpose(1, 2), xc)
    return mu, cov


class Resampler:
    """Resampler protocol: ``__call__(model, generator, weights, locations)
    -> (new_weights, new_locations)``. :meth:`call_with_diagnostics` also
    returns the number of slots that needed a degraded fallback."""

    def __call__(self, model, generator, particle_weights,
                 particle_locations):
        w, x, _ = self.call_with_diagnostics(
            model, generator, particle_weights, particle_locations)
        return w, x

    def call_with_diagnostics(self, model, generator, particle_weights,
                              particle_locations):
        raise NotImplementedError


class LiuWestResampler(Resampler):
    """Liu-West kernel-shrinkage resampler: weighted mean μ and covariance
    Σ; shrinkage ``h = sqrt(1 − a²)``; systematic ancestors; proposals
    ``x' = a·x_anc + (1−a)·μ + h·L·z`` with ``L Lᵀ = Σ``; validity redraw
    against ``model.are_models_valid``; ``model.canonicalize``; uniform
    weights. ``a=1`` (⇒ h=0) is plain bootstrap resampling.

    :param float a: shrinkage parameter in (0, 1].
    :param float h: kernel bandwidth override (default ``sqrt(1 - a**2)``).
    :param int maxiter: redraw rounds for validity postselection.
    :param bool postselect: disable to skip the validity redraw.
    :param float zero_cov_comp: diagonal jitter added to Σ.
    :param bool canonicalize: apply ``model.canonicalize`` to the output.

    ``redraw_rounds`` lists the validity redraw rounds of each call.
    """

    def __init__(self, a=0.98, h=None, maxiter=10, postselect=True,
                 zero_cov_comp=1e-10, canonicalize=True):
        self.a = float(a)
        self.h = (float(h) if h is not None
                  else math.sqrt(max(1.0 - self.a ** 2, 0.0)))
        self.maxiter = int(maxiter)
        self.postselect = bool(postselect)
        self.zero_cov_comp = float(zero_cov_comp)
        self.canonicalize = bool(canonicalize)
        self.redraw_rounds = []

    def call_with_diagnostics(self, model, generator, particle_weights,
                              particle_locations):
        """:return: ``(weights, locations, n_fallback)``, ``n_fallback`` a
        0-d int32 tensor counting slots that kept their ancestor."""
        x = particle_locations.contiguous()  # K3 reads whole rows
        return self._resample(model, generator, particle_weights, x,
                              counting_locations_from_u)

    def call_batch_with_diagnostics(self, model, generator, weights,
                                    locations):
        """Liu-West resampling of T' independent ensembles at once:
        ``weights`` (T', n), ``locations`` (T', n, d). Each ensemble gets
        its own moments, Cholesky factor and uniform offset (``u``, the
        first draw, (T',)), its own counts along its row, and the fill is
        ONE K3 launch over all T'·n rows
        (:func:`counting_locations_batch_from_u`; no other route). The
        validity rounds run until every ensemble's redraw is valid or
        ``maxiter`` rounds have passed, each ensemble keeping its own
        fallback count.

        :return: ``(weights (T', n), locations (T', n, d), n_fallback
            (T',) int32)``.
        """
        return self._resample(
            model, generator, weights, locations.contiguous(),
            lambda u, w, x: counting_locations_batch_from_u(u, w, x)[0])

    def _resample(self, model, generator, w, x, fill):
        """The resample of one ensemble (``w`` (n,), ``x`` (n, d)) or of T'
        at once (a leading axis on both): the uniform offsets are the
        first draw, then each ensemble's moments and Cholesky factor, the
        counting fill ``fill(u, w, x)``, the proposals, the validity
        rounds and the canonicalization."""
        n, d = x.shape[-2:]
        batch = x.shape[:-2]
        dev = x.device
        u = torch.rand(batch, generator=generator, device=dev)
        mu, cov = (weighted_moments if not batch else _batched_moments)(w, x)
        cov = cov + self.zero_cov_comp * torch.eye(d, dtype=cov.dtype,
                                                   device=dev)
        # any L with L Lᵀ = Σ gives the same proposal law; the eigh route
        # is the fallback for a Σ that Cholesky refuses, ensemble by
        # ensemble
        L, info = torch.linalg.cholesky_ex(cov)
        bad = ((info != 0) | torch.isnan(L).flatten(-2).any(dim=-1)
               ).reshape(-1)
        if bool(bad.any()):
            L = L.reshape(-1, d, d).clone()
            cov_rows = cov.reshape(-1, d, d)
            for t in torch.nonzero(bad).flatten().tolist():
                L[t] = sqrtm_psd(cov_rows[t])
            L = L.reshape(cov.shape)
        S_T = (L * self.h).mT

        x_anc = fill(u, w, x)
        centers = self.a * x_anc + (1.0 - self.a) * mu[..., None, :]

        def propose():
            z = torch.randn(x.shape, generator=generator, device=dev)
            return centers + z @ S_T

        def valid_of(y):
            return model.are_models_valid(y.reshape(-1, d)).reshape(
                y.shape[:-1])

        new_x = propose()
        n_fallback = torch.zeros(batch, dtype=torch.int32, device=dev)
        if self.postselect and self.maxiter > 0:
            valid = valid_of(new_x)
            # early exit: the common case needs no redraw round at all
            it = 0
            while it < self.maxiter and not bool(valid.all()):
                fresh = propose()
                fresh_valid = valid_of(fresh)
                take = ~valid & fresh_valid
                new_x = torch.where(take[..., None], fresh, new_x)
                valid = valid | fresh_valid
                it += 1
            self.redraw_rounds.append(it)
            # slots still invalid inherit their (valid) ancestor
            n_fallback = torch.sum(~valid, dim=-1).to(torch.int32)
            new_x = torch.where(valid[..., None], new_x, x_anc)

        if self.canonicalize:
            new_x = model.canonicalize(new_x.reshape(-1, d)).reshape(
                new_x.shape)
        new_w = torch.full(w.shape, 1.0 / n, dtype=w.dtype, device=dev)
        return new_w, new_x, n_fallback
