"""Particle resamplers (counterpart of :mod:`qinfer_tpu.resamplers`).

Ancestor selection is systematic resampling in its sort-free counting form:
one cumsum gives every particle's copy count ``m_i`` and first output slot,
and kernel K3 (:func:`~qinfer_tpu_torch.ops.streaming_resample.
streaming_resample_locations`) expands the survivors into their spans with
no scatter and no gather. The Liu-West resampler then draws the shrinkage
proposal, redraws invalid proposals for at most ``maxiter`` rounds and
falls back to the ancestor for slots still invalid.
"""

from __future__ import annotations

import math

import torch

from .config import EPS
from .ops.streaming_resample import streaming_resample_locations
from .utils import weighted_moments, sqrtm_psd

__all__ = ["Resampler", "LiuWestResampler",
           "counting_multiplicities_from_u", "counting_locations_from_u"]


def counting_multiplicities_from_u(u, weights, n_out):
    """Per-particle copy counts and output offsets of systematic resampling
    with uniform offset ``u``, from ONE cumsum and elementwise math.

    ``m_i = ceil(n·F_i − u) − ceil(n·F_{i−1} − u)`` counts the stratified
    positions ``(j + u)/n`` that land in ``(F_{i−1}, F_i]``; the exclusive
    cumsum of ``m`` is ``ceil(n·F_{i−1} − u)`` itself. ``n·F`` amplifies
    float32 CDF rounding, so a boundary assignment can shift by one slot
    relative to another summation order; ``Σ m = n`` holds exactly.

    :param u: uniform offset in [0, 1) (number or 0-d tensor).
    :return: ``(m, offsets)``, both (n,) int32.
    """
    cdf = torch.cumsum(weights, dim=0)
    # a parallel cumsum (the GPU's) may leave a prefix an ulp above the
    # total; the clamp keeps every ceiling at or below n_out so Σ m = n_out
    cdf = torch.clamp_max(cdf / torch.clamp_min(cdf[-1], EPS), 1.0)
    upper = torch.ceil(n_out * cdf - u)
    # the prefix sums can also dip by an ulp; cummax restores monotonicity
    # so no m is negative and no spans overlap
    upper = torch.cummax(upper, dim=0).values
    lower = torch.cat([torch.zeros_like(upper[:1]), upper[:-1]])
    m = (upper - lower).to(torch.int32)
    offsets = torch.clamp_min(lower, 0.0).to(torch.int32)
    return m, offsets


def counting_locations_from_u(u, weights, locations):
    """Systematic resample-to-locations with uniform offset ``u``: the
    counting multiplicities expanded by kernel K3. Returns (n, d)."""
    m, offsets = counting_multiplicities_from_u(
        u, weights, locations.shape[0])
    return streaming_resample_locations(m, offsets, locations)


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
        w = particle_weights
        x = particle_locations.contiguous()  # K3 reads whole rows
        n, d = x.shape
        dev = x.device

        mu, cov = weighted_moments(w, x)
        cov = cov + self.zero_cov_comp * torch.eye(d, dtype=cov.dtype,
                                                   device=dev)
        # any L with L Lᵀ = Σ gives the same proposal law; the eigh route
        # is the fallback for a Σ that Cholesky refuses
        L, info = torch.linalg.cholesky_ex(cov)
        if bool((info != 0) | torch.isnan(L).any()):
            L = sqrtm_psd(cov)
        S = L * self.h

        u = torch.rand((), generator=generator, device=dev)
        x_anc = counting_locations_from_u(u, w, x)
        centers = self.a * x_anc + (1.0 - self.a) * mu[None, :]

        def propose():
            z = torch.randn((n, d), generator=generator, device=dev)
            return centers + z @ S.T

        new_x = propose()
        n_fallback = torch.zeros((), dtype=torch.int32, device=dev)
        if self.postselect and self.maxiter > 0:
            valid = model.are_models_valid(new_x)
            # early exit: the common case needs no redraw round at all
            it = 0
            while it < self.maxiter and not bool(valid.all()):
                fresh = propose()
                fresh_valid = model.are_models_valid(fresh)
                take = ~valid & fresh_valid
                new_x = torch.where(take[:, None], fresh, new_x)
                valid = valid | fresh_valid
                it += 1
            self.redraw_rounds.append(it)
            # slots still invalid inherit their (valid) ancestor
            n_fallback = torch.sum(~valid).to(torch.int32)
            new_x = torch.where(valid[:, None], new_x, x_anc)

        if self.canonicalize:
            new_x = model.canonicalize(new_x)
        new_w = torch.full((n,), 1.0 / n, dtype=w.dtype, device=dev)
        return new_w, new_x, n_fallback
