"""Faults planted in the program for the tests (``run.py --plant
perfbench.tests.faults:<name>``): each breaks the timed path underneath the
harness, which must then report ``correct`` false."""

from __future__ import annotations

import dataclasses

import torch

from qinfer_tpu_torch import rejuvenation, resamplers, smc
from qinfer_tpu_torch.parallel.mesh import ParticleMesh


def unchanged():
    """A step that returns its state unchanged."""

    def step(model, resampler, state, *args, **kwargs):
        return dataclasses.replace(state, just_resampled=False), 0.0, False

    smc._update_step = step


def half_batch():
    """Half of the batch left out: the reweighting's sums over the first
    half only."""
    reweight = smc._reweight

    def half(model, weights, locations, outcome, eps, generator=None,
             reducer=smc.LOCAL):
        keep = torch.ones_like(weights)
        keep[weights.shape[0] // 2:] = 0.0
        return reweight(model, weights * keep, locations, outcome, eps,
                        generator, reducer)

    smc._reweight = half


def altered():
    """The outcome altered where the step takes it: the other bit, or the
    other shots' count."""
    step = smc._update_step

    def flipped(model, resampler, state, outcome, eps, *args, **kwargs):
        shots = eps.get("n_meas")
        if shots is not None:
            outcome = shots.reshape(outcome.shape).to(outcome.dtype) - outcome
        else:
            outcome = 1 - outcome
        return step(model, resampler, state, outcome, eps, *args, **kwargs)

    smc._update_step = flipped


def ignores_weights():
    """A resampler that ignores the weights: uniform ancestors and moments,
    then its validity rounds and projection as before."""
    call = resamplers.LiuWestResampler.call_with_diagnostics

    def uniform(self, model, generator, weights, locations):
        return call(self, model, generator, torch.full_like(
            weights, 1.0 / weights.shape[-1]), locations)

    resamplers.LiuWestResampler.call_with_diagnostics = uniform


def returns_input():
    """A resampler that returns its input cloud with uniform weights."""

    def same(self, model, generator, weights, locations):
        return (torch.full_like(weights, 1.0 / weights.shape[-1]),
                locations, torch.zeros((), dtype=torch.int32,
                                       device=locations.device))

    resamplers.LiuWestResampler.call_with_diagnostics = same


def moves_skipped():
    """Moves that return their input and accept nothing."""

    def skip(model, prior, generator, locations, succ, trials, eps_pool,
             n_moves, log_scale, adapt_t, **kwargs):
        return (locations, torch.zeros((), device=locations.device),
                log_scale, adapt_t)

    rejuvenation.mcmc_rejuvenate_binomial_adaptive = skip


def moves_ignore_record():
    """Moves whose target leaves out the record's likelihood: a random
    walk over the valid states."""

    def flat(model, locations, *args, **kwargs):
        return torch.zeros(locations.shape[0], dtype=locations.dtype,
                           device=locations.device)

    rejuvenation.binomial_record_log_likelihood = flat


def no_exchange():
    """The exchange between cards left out: each rank's sum is its own."""

    def local(self, stacked):
        return stacked.sum(dim=0)

    ParticleMesh.psum = local
