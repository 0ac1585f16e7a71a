"""Two-level Liu-West resampling over a particle mesh (counterpart of
:mod:`qinfer_tpu.parallel.resample`).

Two-level systematic resampling (Murray et al., "Parallel resampling in
the particle filter"):

1. *Shard level*: the D shard masses ``W_s`` are D super-particles; one
   uniform ``u₁``, the same for every shard, draws a systematic
   allocation over them, so output shard ``s`` takes the block of
   ancestor shard ``A_s`` (:func:`shard_systematic_ancestors`). The blocks
   travel by the mesh's ``ppermute``: a ring of D − 1 rounds, or a
   butterfly of 3·log₂D rounds (:func:`butterfly_exchange_schedule`).
   Both deliver block ``A_s`` to shard ``s`` exactly, so both give the
   same bits.
2. *Local level*: each shard draws its own uniform ``u₂[s]`` and counts
   its n/D slots over the received block's weights; the fill of the
   shards a process holds is ONE launch of kernel K3 over their rows
   (:func:`~qinfer_tpu_torch.resamplers.counting_locations_batch_from_u`:
   shard s's offsets shifted by its row), so one launch over all D·n/D
   rows in one process, and over the rank's n/D rows on a mesh across
   processes.

Copy count of particle i of shard d: ``E[#shards with A = d] · (n/D) ·
w_i / W_d = n·w_i``, unbiased, with uniform output weights and n/D
particles on every shard. The Liu-West kernel then shrinks the ancestors
toward the GLOBAL mean, with the global covariance, both summed from
per-shard partials by ``psum``.

The code is written once over the mesh's local stacked view ``(L, n/D,
...)`` (:meth:`~qinfer_tpu_torch.parallel.ParticleMesh.shard`), so a
mesh in one process (L = D) and a mesh across processes (L = 1, one
shard a rank) run the same lines.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from ..config import EPS
from ..resamplers import (Resampler, counting_locations_batch_from_u,
                          propose_valid, shrinkage_factor)
from ..utils import cumsum_last
from .mesh import reducer_of, shard_generators

__all__ = ["DistributedLiuWestResampler", "shard_systematic_ancestors",
           "butterfly_exchange_schedule", "exchange_blocks",
           "shard_generators", "two_level_fill"]


def shard_systematic_ancestors(u, shard_masses):
    """Level 1: the ancestor shard of every output shard, systematic over
    the D shard masses at offset ``u`` (the CDF's first entry at or above
    each position ``(s + u)/D``). (D,) int64."""
    d = shard_masses.shape[0]
    cdf = cumsum_last(shard_masses)
    cdf = cdf / torch.clamp_min(cdf[-1], EPS)
    positions = (torch.arange(d, dtype=cdf.dtype, device=cdf.device)
                 + u) / d
    return torch.clamp(torch.searchsorted(cdf, positions), 0, d - 1)


def _marked(n, index):
    """A (n,) bool tensor, True at ``index``; entries outside [0, n) are
    dropped. (``index_fill_`` takes the value as a scalar argument; an
    indexed assignment would copy it to the device and wait.)"""
    out = torch.zeros(n + 1, dtype=torch.bool, device=index.device)
    out.index_fill_(0, torch.where((index >= 0) & (index < n), index, n),
                    True)
    return out[:n]


def butterfly_exchange_schedule(anc_shard, n_dev):
    """The log-depth block exchange: block ``d`` reaches every output shard
    ``s`` with ``anc_shard[s] == d`` in 3·log₂D rounds of fixed rotations
    with data-dependent take masks, computed on ``anc_shard``'s device
    (no host copy).

    ``anc_shard`` is non-decreasing (systematic over the shard masses), so
    each surviving source's destinations form one segment ``[lo_d, hi_d]``,
    and the exchange is three collision-free phases, each shard relaying
    at most one block at a time: (1) compact the survivors to a rank
    prefix (backward hops 1, 2, …, D/2 on the bits of each distance
    ``d_r − r``); (2) spread rank r to its segment start ``lo_r`` (forward
    hops D/2, …, 1 on the bits of ``lo_r − r``); (3) broadcast within each
    segment (forward hops D/2, …, 1; a shard takes the block from ``s − h``
    when it lacks its own and both belong to one segment).

    :return: ``(shifts, takes)``: the forward rotation of each round
        (negative: backward) and a ``(3·log₂D, D)`` bool tensor,
        ``takes[k, s]`` true where shard ``s`` replaces its buffer by the
        one arriving from shard ``s − shifts[k]`` in round ``k``.
    :raises ValueError: unless D is a power of two, at least 2.
    """
    D = int(n_dev)
    if D < 2 or D & (D - 1):
        raise ValueError("butterfly exchange needs a power-of-two mesh")
    log_d = D.bit_length() - 1
    dev = anc_shard.device
    anc = anc_shard.to(torch.int64)
    r = torch.arange(D, device=dev)
    mult = torch.zeros(D, dtype=torch.int64, device=dev).index_add_(
        0, anc, torch.ones_like(anc))
    lo = torch.cumsum(mult, 0) - mult
    alive = mult > 0
    rank_of_d = torch.cumsum(alive.to(torch.int64), 0) - 1
    n_surv = alive.sum()
    # the source of each rank; ranks at or past n_surv are inactive
    d_of_r = torch.full((D + 1,), D, dtype=torch.int64, device=dev)
    d_of_r[torch.where(alive, rank_of_d, D)] = r
    active = r < n_surv
    d_safe = torch.clamp_max(d_of_r[:D], D - 1)
    m = torch.where(active, d_safe - r, 0)  # compaction distance
    delta = torch.where(active, lo[d_safe] - r, 0)  # spread distance
    sentinel = D + r  # an inactive candidate matches no shard

    shifts, takes = [], []
    for k in range(log_d):  # compact: backward, lowest bit first
        h = 1 << k
        pos = torch.where(active, d_safe - m % h, sentinel)
        moves = ((m // h) % 2 == 1) & active
        takes.append(_marked(D, torch.where(moves, pos - h, D)))
        shifts.append(-h)
    for k in range(log_d - 1, -1, -1):  # spread: forward, highest first
        h = 1 << k
        pos = torch.where(active, r + delta - delta % (2 * h), sentinel)
        moves = ((delta // h) % 2 == 1) & active
        takes.append(_marked(D, torch.where(moves, pos + h, D)))
        shifts.append(h)
    have = _marked(D, torch.where(active, torch.clamp_max(lo[d_safe], D - 1),
                                  D))
    for k in range(log_d - 1, -1, -1):  # broadcast within the segments
        h = 1 << k
        take = torch.roll(have, h) & (anc == torch.roll(anc, h)) & ~have
        shifts.append(h)
        takes.append(take)
        have = have | take
    return shifts, torch.stack(takes)


def exchange_blocks(mesh, u1, w, x, exchange="ring"):
    """Level 1 on the local stacked ``w`` (L, n/D) and ``x`` (L, n/D, d):
    the ancestor shards at offset ``u1`` from the all-gathered shard
    masses (the same on every shard) and the block exchange by the mesh's
    ``ppermute`` (``'ring'``: D − 1 rounds, each shard keeping the block
    that comes from its ancestor; ``'butterfly'``:
    :func:`butterfly_exchange_schedule`, the weights riding as one more
    column, each shard applying its own row of ``takes``). Returns the
    received ``(w, x)``, block ``A_s`` on shard s."""
    D = mesh.n_devices
    anc = shard_systematic_ancestors(u1, mesh.all_gather(w.sum(dim=1)))
    idx = mesh.axis_index(w.device)
    if exchange == "butterfly":
        shifts, takes = butterfly_exchange_schedule(anc, D)
        takes = takes[:, idx]
        buf = torch.cat([x, w[..., None]], dim=-1)
        for k, shift in enumerate(shifts):
            buf = torch.where(takes[k][:, None, None],
                              mesh.ppermute(buf, shift), buf)
        return buf[..., -1].contiguous(), buf[..., :-1].contiguous()
    my_anc = anc[idx]
    recv_w, recv_x = w, x
    for k in range(1, D):
        take = my_anc == (idx - k) % D
        recv_w = torch.where(take[:, None], mesh.ppermute(w, k), recv_w)
        recv_x = torch.where(take[:, None, None], mesh.ppermute(x, k),
                             recv_x)
    return recv_w, recv_x


def two_level_fill(mesh, u1, u2, w, x, exchange="ring"):
    """The two-level systematic fill of the local stacked ``w`` (L, n/D)
    and ``x`` (L, n/D, d): the block exchange at ``u1``
    (:func:`exchange_blocks`), then each local shard's counting fill at
    its own ``u2[s]`` ((L,)), ONE K3 launch over the local shards' rows.
    (L, n/D, d)."""
    with tracing.span("resample.exchange"):
        recv_w, recv_x = exchange_blocks(mesh, u1, w, x, exchange)
    return counting_locations_batch_from_u(u2, recv_w, recv_x)[0]


class DistributedLiuWestResampler(Resampler):
    """Liu-West resampling that decomposes over a 1-D particle mesh: the
    port's resampler signature ``(model, generator, weights, locations)``
    on an ensemble sharded over ``mesh``, with only the mesh's collectives
    between shards.

    Draws ``u₁`` (one, for every shard) from ``generator``, which must
    give the same values on every rank; then each shard draws ``u₂[s]``,
    its proposals and each validity round's fresh proposals from its own
    generator (:func:`shard_generators`), so a mesh across processes sees
    the draws of a one-process mesh of the same D (the JAX package folds
    the shard index into its key; the laws agree, the streams do not).
    The validity rounds run until every shard's slots are valid (on a mesh
    across processes, an all-reduce of the ranks' verdicts, so every rank
    runs the same rounds) or ``maxiter`` rounds have passed; the
    canonicalization always runs, and the output weights are 1/n.

    While a recording of :mod:`qinfer_tpu_torch.tracing` is on, a call is
    the one-card resampler's span tree: ``resample``, with
    ``resample.ancestors`` (the fill, ``resample.exchange`` around the
    block exchange inside it), ``resample.proposal`` (the proposals and
    the validity rounds) and ``resample.project``. The weights' global
    total and the moments, which the fill and the proposals both read, and
    the fallback count's sum are ``resample``'s own time.

    :param mesh: the :class:`~qinfer_tpu_torch.parallel.ParticleMesh`.
    :param str axis_name: its axis (must be the mesh's).
    :param float a: Liu-West shrinkage (h = sqrt(1 − a²)).
    :param int maxiter: validity redraw rounds.
    :param float zero_cov_comp: diagonal jitter added to the covariance.
    :param str exchange: ``'ring'`` (D − 1 rounds), ``'butterfly'``
        (3·log₂D rounds; a power-of-two mesh only) or ``'auto'``
        (butterfly when 3·log₂D < D − 1, on a power-of-two mesh). Ring and
        butterfly give the same bits.
    """

    canonicalize = True

    def __init__(self, mesh, axis_name="particles", a=0.98, h=None,
                 maxiter=10, zero_cov_comp=1e-10, exchange="auto"):
        if axis_name != mesh.axis_name:
            raise ValueError(f"the mesh has axis {mesh.axis_name!r}, not "
                             f"{axis_name!r}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.a = float(a)
        self.h = (float(h) if h is not None
                  else math.sqrt(max(1.0 - self.a ** 2, 0.0)))
        self.maxiter = int(maxiter)
        self.zero_cov_comp = float(zero_cov_comp)
        if exchange not in ("auto", "ring", "butterfly"):
            raise ValueError("exchange must be 'auto', 'ring' or "
                             "'butterfly'")
        n_dev = mesh.n_devices
        pow2 = n_dev >= 2 and (n_dev & (n_dev - 1)) == 0
        if exchange == "butterfly" and not pow2:
            raise ValueError(f"butterfly exchange needs a power-of-two "
                             f"mesh, got {n_dev} devices")
        if exchange == "auto":
            exchange = ("butterfly" if pow2 and 3 * (n_dev.bit_length() - 1)
                        < n_dev - 1 else "ring")
        self.exchange = exchange

    def fill_inputs(self, generator, particle_weights, particle_locations):
        """What a call's fill starts from: ``(u1, u2, w, x, generators)``,
        the offset ``u1`` (0-d) drawn from ``generator`` (the first and
        only draw from it), the shard generators
        (:func:`shard_generators`), each shard's offset ``u2[s]`` (L,), its
        generator's first draw, and the local stacked weights, normalized
        by their global total (``psum`` of the shards' sums), and
        locations."""
        mesh = self.mesh
        dev = particle_locations.device
        u1 = torch.rand((), generator=generator, device=dev)
        gens = shard_generators(generator, mesh, dev)
        u2 = torch.stack([torch.rand((), generator=g, device=dev)
                          for g in gens])
        w = mesh.shard(particle_weights)
        x = mesh.shard(particle_locations.contiguous())
        return (u1, u2, w / torch.clamp_min(mesh.psum(w.sum(dim=1)), EPS), x,
                gens)

    def call_with_diagnostics(self, model, generator, particle_weights,
                              particle_locations):
        """:return: ``(weights, locations, n_fallback)``: this process's
        rows of the new ensemble, and ``n_fallback``, a 0-d int32 tensor
        counting the slots of every shard that kept their ancestor (the
        same on every rank)."""
        mesh = self.mesh
        d = particle_locations.shape[1]
        dev = particle_locations.device
        with tracing.span("resample"):
            u1, u2, w, x, gens = self.fill_inputs(
                generator, particle_weights, particle_locations)
            # global moments from per-shard partials, and the Cholesky
            # verdict's wait, ahead of the fill: the proposals' launches
            # then queue behind the fill on the card
            mu = mesh.psum(torch.bmm(w[:, None, :], x)[:, 0, :])
            xc = x - mu
            cov = mesh.psum(torch.bmm((xc * w[..., None]).mT, xc))
            cov = cov + self.zero_cov_comp * torch.eye(d, dtype=cov.dtype,
                                                       device=dev)
            S_T = (shrinkage_factor(cov) * self.h).mT
            with tracing.span("resample.ancestors"):
                x_anc = two_level_fill(mesh, u1, u2, w, x, self.exchange)
            with tracing.span("resample.proposal"):
                centers = self.a * x_anc + (1.0 - self.a) * mu
                new_x, n_fallback, _ = propose_valid(
                    model, gens, centers, S_T, x_anc, self.maxiter,
                    all_valid=reducer_of(mesh.particle_sharding).all)
            with tracing.span("resample.project"):
                new_x = model.canonicalize(mesh.unshard(new_x))
            n = mesh.n_devices * x.shape[1]
            new_w = torch.full((new_x.shape[0],), 1.0 / n,
                               dtype=particle_weights.dtype, device=dev)
            return new_w, new_x, mesh.psum(n_fallback).to(torch.int32)
