"""Experiment-design heuristics (counterpart of
:mod:`qinfer_tpu.heuristics`: ``Heuristic``, ``PGH``,
``ExpSparseHeuristic`` and ``IdentityHeuristic``).

Every heuristic has a pure form ``propose(generator, weights, locations,
idx_exp) -> expparams dict`` that stays on the particles' device (no
device→host copy), and the reference's host API ``__call__(idx_exp)``,
which draws from the bound updater's generator.
"""

from __future__ import annotations

import numpy as np
import torch

from .abstract_model import _field
from .config import EPS

__all__ = ["Heuristic", "PGH", "ExpSparseHeuristic", "IdentityHeuristic",
           "categorical_inverse_cdf"]


def categorical_inverse_cdf(generator, weights):
    """One index drawn with probability ∝ ``weights`` (non-negative, not
    necessarily normalized), by inverse CDF on one uniform: a cumsum and a
    binary search, with no device→host copy and no cap on the number of
    categories. The draw lies strictly below the total, so a zero-weight
    category is never chosen. Returns a 1-element int64 tensor."""
    cdf = torch.cumsum(weights, dim=0)
    total = cdf[-1:]
    u = torch.rand((1,), generator=generator, device=weights.device,
                   dtype=weights.dtype)
    below_total = torch.nextafter(total, torch.zeros_like(total))
    v = torch.minimum(u * total, below_total)
    return torch.searchsorted(cdf, v, right=True).clamp_max(
        weights.shape[0] - 1)


class Heuristic:
    """Experiment heuristic bound to an updater: ``__call__(idx_exp) ->
    expparams``."""

    def __init__(self, updater):
        self._updater = updater
        self.model = getattr(updater, "model", None)

    @property
    def updater(self):
        return self._updater

    def __call__(self, idx_exp=0):
        st = self._updater.state
        return self.propose(self._updater.generator, st.weights,
                            st.locations, idx_exp)

    def propose(self, generator, weights, locations, idx_exp):
        """Pure proposal; returns an expparams dict with one experiment."""
        raise NotImplementedError


class PGH(Heuristic):
    """Particle guess heuristic: draw two distinct particles x₁, x₂ from the
    posterior and choose ``t = 1 / ‖x₁ − x₂‖`` (Q-weighted distance),
    setting the inversion field to x₁.

    The second draw excludes the first particle's index outright (the
    distribution of the reference's redraw-until-distinct loop, with no
    loop); the distance is clamped below by ``min_separation`` for exact
    location ties between distinct particles.
    """

    def __init__(self, updater, inv_field="x_", t_field="t",
                 inv_func=None, t_func=None, other_fields=None,
                 min_separation=1e-12):
        super().__init__(updater)
        self.inv_field = inv_field
        self.t_field = t_field
        self.inv_func = inv_func
        self.t_func = t_func
        self.other_fields = dict(other_fields or {})
        self.min_separation = float(min_separation)

    def propose(self, generator, weights, locations, idx_exp):
        p = torch.clamp_min(weights, EPS)
        i = categorical_inverse_cdf(generator, p)
        j = categorical_inverse_cdf(generator, p.scatter(0, i, 0.0))
        x1 = locations[i]  # (1, d)
        x2 = locations[j]
        model = self.model
        if model is not None:
            sep = model.distance(x1, x2)  # (1,)
        else:
            sep = torch.linalg.vector_norm(x1 - x2, dim=-1)
        t = 1.0 / torch.clamp_min(sep, self.min_separation)
        if self.t_func is not None:
            t = self.t_func(t)
        eps = {self.t_field: t.reshape(1)}
        inv = x1[0] if self.inv_func is None else self.inv_func(x1[0])
        if model is not None:
            names = [f[0] for f in model.expparams_dtype]
            d = locations.shape[1]
            if d == 1:
                if self.inv_field in names:
                    eps[self.inv_field] = inv[:1]
            else:
                for k_idx in range(d):
                    fname = f"{self.inv_field}{k_idx}"
                    if fname in names:
                        eps[fname] = inv[k_idx:k_idx + 1]
                if self.inv_field in names:
                    eps[self.inv_field] = inv[None, :]
        for fname, val in self.other_fields.items():
            eps[fname] = torch.as_tensor(val, device=locations.device
                                         ).reshape(-1)
        return eps


class ExpSparseHeuristic(Heuristic):
    """Exponentially sparse, non-adaptive times t_k = scale · base^k
    (``qinfer_tpu/heuristics.py:125``), computed in float32 log space and
    capped at e^60 ≈ 1.1e26: base^k overflows float32 at k ≥ 128 for
    base 2, and cos(inf) would turn the posterior to NaN. The time is
    worked out on the host and written on the particles' device by a fill
    (no host→device copy)."""

    def __init__(self, updater, scale=1.0, base=2.0, t_field="t",
                 other_fields=None):
        super().__init__(updater)
        self.scale = float(scale)
        self.base = float(base)
        self.t_field = t_field
        self.other_fields = dict(other_fields or {})

    def time(self, idx_exp):
        """t at experiment ``idx_exp`` (a float32 NumPy scalar)."""
        f32 = np.float32
        log_t = (np.log(f32(self.scale))
                 + f32(int(idx_exp)) * np.log(f32(self.base)))
        return np.exp(np.minimum(log_t, f32(60.0)))

    def propose(self, generator, weights, locations, idx_exp):
        dev = locations.device
        eps = {self.t_field: torch.full((1,), float(self.time(idx_exp)),
                                        dtype=torch.float32, device=dev)}
        for fname, val in self.other_fields.items():
            eps[fname] = torch.as_tensor(val, device=dev).reshape(-1)
        return eps


class IdentityHeuristic(Heuristic):
    """Always the same experiment (``qinfer_tpu/heuristics.py:153``), kept
    on each device it is asked for once."""

    def __init__(self, updater, expparams):
        super().__init__(updater)
        self.expparams = {k: _field(v) for k, v in expparams.items()}
        self._on = {}

    def propose(self, generator, weights, locations, idx_exp):
        dev = locations.device
        if dev not in self._on:
            self._on[dev] = {k: v.to(dev) for k, v in self.expparams.items()}
        return self._on[dev]
