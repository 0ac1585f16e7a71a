"""Prior distributions (counterpart of :mod:`qinfer_tpu.distributions`:
``Distribution``, ``UniformDistribution``, ``PostselectedDistribution`` and
``ParticleDistribution``).

Sampling takes an explicit :class:`torch.Generator`; samples land on the
generator's device. A prior that rejuvenation moves may target says so
with a ``log_pdf`` or with ``is_flat_on_support``
(:func:`qinfer_tpu_torch.rejuvenation.resolve_prior_log_pdf`).
"""

from __future__ import annotations

import torch

from .config import EPS
from .utils import particle_covariance_mtx

__all__ = ["Distribution", "UniformDistribution", "PostselectedDistribution",
           "ParticleDistribution"]


class Distribution:
    """A distribution over ``n_rvs`` real random variables:
    ``sample(generator, n) -> (n, n_rvs)``."""

    @property
    def n_rvs(self):
        raise NotImplementedError

    def sample(self, generator, n=1):
        raise NotImplementedError


class UniformDistribution(Distribution):
    """Uniform over an axis-aligned box given as ``[[lo, hi], ...]`` (or a
    single ``[lo, hi]`` pair for one variable)."""

    def __init__(self, ranges):
        ranges = torch.as_tensor(ranges, dtype=torch.float32)
        while ranges.ndim < 2:
            ranges = ranges.unsqueeze(0)
        if ranges.ndim != 2 or ranges.shape[-1] != 2:
            raise ValueError("ranges must be of shape (n_rvs, 2)")
        self.ranges = ranges
        self._ranges_on = {}

    @property
    def n_rvs(self):
        return self.ranges.shape[0]

    def sample(self, generator, n=1):
        ranges = self.ranges.to(generator.device)
        lo = ranges[:, 0]
        hi = ranges[:, 1]
        u = torch.rand((n, self.n_rvs), generator=generator,
                       device=generator.device)
        return lo + u * (hi - lo)

    def grad_log_pdf(self, x):
        """∇ log p: zero inside the box (the BCRB's prior term)."""
        return torch.zeros_like(torch.as_tensor(x))

    is_flat_on_support = True

    def log_pdf(self, x):
        """(n,) log-density: −log of the box's volume inside, −inf
        outside."""
        x = torch.as_tensor(x)
        while x.ndim < 2:
            x = x.unsqueeze(0)
        key = (x.device, x.dtype)
        if key not in self._ranges_on:
            # one copy to a device, not one each move sweep
            self._ranges_on[key] = self.ranges.to(device=x.device,
                                                  dtype=x.dtype)
        ranges = self._ranges_on[key]
        lo, hi = ranges[:, 0], ranges[:, 1]
        inside = torch.all((x >= lo) & (x <= hi), dim=-1)
        log_vol = torch.sum(torch.log(hi - lo))
        return torch.where(inside, -log_vol, -torch.inf)


class PostselectedDistribution(Distribution):
    """A base distribution postselected on a model's validity constraint:
    draws that ``model.are_models_valid`` rejects are redrawn, in masked
    rounds of ``n`` fresh draws on the generator, until every slot is valid
    (the common case pays one round and one sync). ``sample`` raises
    :class:`RuntimeError` when slots are still invalid after ``maxiters``
    rounds, instead of seeding an ensemble with invalid particles."""

    def __init__(self, distribution, model, maxiters=100):
        self.distribution = distribution
        self.model = model
        self.maxiters = int(maxiters)

    @property
    def n_rvs(self):
        return self.distribution.n_rvs

    def log_pdf(self, x):
        """The base log-density inside the validity region, −inf outside;
        unnormalized (the acceptance mass is a constant that cancels in
        Metropolis ratios and in gradients)."""
        x = torch.as_tensor(x)
        while x.ndim < 2:
            x = x.unsqueeze(0)
        lp = self.distribution.log_pdf(x)
        return torch.where(self.model.are_models_valid(x), lp, -torch.inf)

    def sample(self, generator, n=1):
        samples = self.distribution.sample(generator, n)
        valid = self.model.are_models_valid(samples)
        it = 0
        while it < self.maxiters and not bool(valid.all()):
            fresh = self.distribution.sample(generator, n)
            fresh_valid = self.model.are_models_valid(fresh)
            take = ~valid & fresh_valid
            samples = torch.where(take[:, None], fresh, samples)
            valid = valid | fresh_valid
            it += 1
        n_bad = int(torch.sum(~valid))
        if n_bad:
            raise RuntimeError(
                f"PostselectedDistribution: {n_bad}/{n} samples still "
                f"invalid after {self.maxiters} rejection rounds; the "
                "model's validity region has very low acceptance under the "
                "base distribution: raise maxiters or fix the base "
                "distribution's support")
        return samples


class ParticleDistribution(Distribution):
    """A weighted particle cloud as a distribution (an SMC posterior handed
    to a fresh updater). Arguments are ``(locations, weights)``; the
    weights default to uniform and are normalized. Draws land on the
    generator's device."""

    def __init__(self, particle_locations, particle_weights=None):
        particle_locations = torch.as_tensor(particle_locations,
                                             dtype=torch.float32)
        while particle_locations.ndim < 2:
            particle_locations = particle_locations.unsqueeze(0)
        n = particle_locations.shape[0]
        if particle_weights is None:
            particle_weights = torch.full((n,), 1.0 / n, dtype=torch.float32,
                                          device=particle_locations.device)
        particle_weights = torch.as_tensor(
            particle_weights, dtype=torch.float32,
            device=particle_locations.device)
        if particle_weights.ndim != 1 or particle_weights.shape[0] != n:
            raise ValueError(
                f"particle_weights must be 1-D with one weight per "
                f"particle; got weights {tuple(particle_weights.shape)} vs "
                f"locations {tuple(particle_locations.shape)} (the argument "
                f"order is (locations, weights))")
        self.particle_locations = particle_locations
        self.particle_weights = particle_weights / torch.sum(particle_weights)

    @property
    def n_rvs(self):
        return self.particle_locations.shape[1]

    @property
    def n_particles(self):
        return self.particle_locations.shape[0]

    @property
    def n_ess(self):
        return 1.0 / torch.sum(self.particle_weights ** 2)

    def est_mean(self):
        return self.particle_weights @ self.particle_locations

    def est_covariance_mtx(self):
        return particle_covariance_mtx(self.particle_weights,
                                       self.particle_locations)

    def sample(self, generator, n=1):
        w = torch.clamp_min(self.particle_weights, EPS).to(generator.device)
        idx = torch.multinomial(w, n, replacement=True, generator=generator)
        return self.particle_locations.to(generator.device)[idx]
