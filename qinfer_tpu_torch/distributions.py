"""Prior distributions (counterpart of :mod:`qinfer_tpu.distributions`:
``Distribution`` and ``UniformDistribution``).

Sampling takes an explicit :class:`torch.Generator`; samples land on the
generator's device. A prior that rejuvenation moves may target says so
with a ``log_pdf`` or with ``is_flat_on_support``
(:func:`qinfer_tpu_torch.rejuvenation.resolve_prior_log_pdf`).
"""

from __future__ import annotations

import torch

__all__ = ["Distribution", "UniformDistribution"]


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
