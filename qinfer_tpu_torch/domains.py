"""Outcome domains (counterpart of :mod:`qinfer_tpu.domains`:
``RealDomain``, ``IntegerDomain`` and ``MultinomialDomain``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Domain", "RealDomain", "IntegerDomain", "MultinomialDomain"]


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


class MultinomialDomain(Domain):
    """Vectors of ``n_elements`` non-negative integer counts summing to
    ``n_meas`` (``qinfer_tpu/domains.py:154``)."""

    def __init__(self, n_meas, n_elements=2):
        self.n_meas = int(n_meas)
        self.n_elements = int(n_elements)

    @property
    def is_continuous(self):
        return False

    @property
    def dtype(self):
        return np.dtype(np.int32)

    @property
    def n_members(self):
        """The compositions of ``n_meas`` into ``n_elements`` parts:
        C(n + k − 1, k − 1)."""
        from math import comb

        return comb(self.n_meas + self.n_elements - 1, self.n_elements - 1)

    @property
    def example_point(self):
        pt = np.zeros((1, self.n_elements), dtype=self.dtype)
        pt[0, 0] = self.n_meas
        return pt

    @property
    def values(self):
        """Every count vector, (n_members, n_elements), in the order of
        :func:`_compositions`."""
        return np.array(list(_compositions(self.n_meas, self.n_elements)),
                        dtype=self.dtype)

    def to_regular_array(self, A):
        """(..., n_elements) count vectors as a 2-d array of rows."""
        return np.asarray(A).reshape(-1, self.n_elements)

    def from_regular_array(self, A):
        """Inverse of :meth:`to_regular_array`."""
        A = np.asarray(A)
        return A.reshape(A.shape[:-1] + (self.n_elements,))

    def in_domain(self, points):
        points = torch.as_tensor(points)
        nonneg = torch.all(points >= 0, dim=-1)
        return nonneg & (torch.sum(points, dim=-1) == self.n_meas)


def _compositions(n, k):
    """Every k-tuple of non-negative integers summing to n, the first
    entry descending (``qinfer_tpu/domains.py:216``)."""
    if k == 1:
        yield (n,)
        return
    for head in range(n, -1, -1):
        for rest in _compositions(n - head, k - 1):
            yield (head,) + rest
