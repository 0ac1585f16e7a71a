"""Outcome domains (counterpart of :mod:`qinfer_tpu.domains`:
``RealDomain`` and ``IntegerDomain``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Domain", "RealDomain", "IntegerDomain"]


class Domain:
    """Abstract base for outcome domains."""

    @property
    def is_continuous(self):
        raise NotImplementedError

    @property
    def is_finite(self):
        return not self.is_continuous

    @property
    def is_discrete(self):
        return not self.is_continuous

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def n_members(self):
        """Number of members for finite domains, else ``None``."""
        return None

    @property
    def example_point(self):
        raise NotImplementedError

    @property
    def values(self):
        """Dense array of all members (finite domains only)."""
        raise NotImplementedError

    def in_domain(self, points):
        """Elementwise membership test on a tensor."""
        raise NotImplementedError


class RealDomain(Domain):
    """A (possibly unbounded) real interval ``[min, max]``."""

    def __init__(self, min=None, max=None):
        self.min = min
        self.max = max

    @property
    def is_continuous(self):
        return True

    @property
    def dtype(self):
        return np.dtype(np.float32)

    @property
    def example_point(self):
        lo = self.min if self.min is not None else 0.0
        return np.array([lo], dtype=self.dtype)

    def in_domain(self, points):
        points = torch.as_tensor(points)
        ok = torch.ones(points.shape, dtype=torch.bool, device=points.device)
        if self.min is not None:
            ok = ok & (points >= self.min)
        if self.max is not None:
            ok = ok & (points <= self.max)
        return ok


class IntegerDomain(Domain):
    """Consecutive integers ``min..max`` inclusive (either may be None for
    an unbounded side)."""

    def __init__(self, min=0, max=None):
        self.min = min
        self.max = max

    @property
    def is_continuous(self):
        return False

    @property
    def is_finite(self):
        return self.min is not None and self.max is not None

    @property
    def dtype(self):
        return np.dtype(np.int32)

    @property
    def n_members(self):
        if not self.is_finite:
            return None
        return int(self.max - self.min + 1)

    @property
    def example_point(self):
        return np.array([self.min if self.min is not None else 0],
                        dtype=self.dtype)

    @property
    def values(self):
        if not self.is_finite:
            raise ValueError("values undefined for an infinite IntegerDomain")
        return np.arange(self.min, self.max + 1, dtype=self.dtype)

    def in_domain(self, points):
        points = torch.as_tensor(points)
        ok = points == torch.round(points).to(points.dtype)
        if self.min is not None:
            ok = ok & (points >= self.min)
        if self.max is not None:
            ok = ok & (points <= self.max)
        return ok
