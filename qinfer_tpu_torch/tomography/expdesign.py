"""Measurement heuristics for tomography (counterpart of
:mod:`qinfer_tpu.tomography.expdesign`: ``RandomPauliHeuristic``,
``RandomStabilizerStateHeuristic``, ``ProductHeuristic`` and
``BestOfKMetaheuristic``).

Measurement effects are coordinate vectors in the model's basis (the
``'meas'`` expparams field), precomputed on the host in NumPy; a proposal
picks one on the updater's device with no device→host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..abstract_model import _field
from ..heuristics import Heuristic
from .bases import pauli_basis

__all__ = [
    "RandomPauliHeuristic",
    "RandomStabilizerStateHeuristic",
    "ProductHeuristic",
    "BestOfKMetaheuristic",
]


def _model_basis(model):
    """Tomography basis of ``model``, reaching through a derived model's
    ``base_model``."""
    base = getattr(model, "base_model", model)
    basis = getattr(base, "basis", None)
    if basis is None:
        raise TypeError(
            f"{type(model).__name__} does not wrap a tomography model "
            "(no .basis found on it or its base_model)")
    return basis


def _projector_coords(basis, vecs):
    """Coordinates of the rank-1 projectors |v⟩⟨v| of kets ``vecs`` (m, d)
    in ``basis`` (host NumPy)."""
    vecs = np.asarray(vecs, dtype=np.complex64)
    projs = np.einsum("ma,mb->mab", vecs, vecs.conj())
    return np.real(np.einsum("iab,mba->mi", np.asarray(basis.data), projs))


def _pick(generator, n_choices):
    """One uniform index in [0, n_choices), drawn on the generator's
    device: a (1,) int64 tensor."""
    return torch.randint(0, n_choices, (1,), generator=generator,
                         device=generator.device)


class _FieldsHeuristic(Heuristic):
    """A heuristic whose proposals carry fixed extra fields
    (``other_fields``, e.g. ``{"t": 1.0}`` for a diffusive model), copied
    to the updater's device once."""

    def __init__(self, updater, other_fields=None):
        super().__init__(updater)
        self.other_fields = dict(other_fields or {})
        self._device = torch.device(updater.device)
        self._fields = {
            name: torch.as_tensor(val, dtype=torch.float32).reshape(-1)
            .to(self._device) for name, val in self.other_fields.items()}

    def _with_fields(self, meas, device):
        eps = {"meas": meas}
        for name, val in self._fields.items():
            eps[name] = val.to(device)
        return eps


class RandomPauliHeuristic(_FieldsHeuristic):
    """Measure the +1 eigenprojector (I + σ)/2 of a uniformly random
    non-identity Pauli string σ."""

    def __init__(self, updater, other_fields=None):
        super().__init__(updater, other_fields)
        basis = _model_basis(updater.model)
        if any(d != 2 for d in basis.dims):
            raise ValueError("RandomPauliHeuristic requires qubit systems")
        d = basis.dim
        eye_coords = np.zeros(basis.n_ops)
        eye_coords[0] = np.sqrt(d)
        self.proj_coords = torch.tensor(
            0.5 * (eye_coords[None, :] + np.sqrt(d) * np.eye(basis.n_ops))[1:],
            dtype=torch.float32, device=self._device)  # (n_ops-1, n_ops)

    def propose(self, generator, weights, locations, idx_exp):
        coords = self.proj_coords.to(locations.device)
        return self._with_fields(
            coords[_pick(generator, coords.shape[0])], locations.device)


#: single-qubit stabilizer states: eigenstates of Z, X, Y
_STABILIZER_KETS = np.array([
    [1, 0],
    [0, 1],
    [1 / np.sqrt(2), 1 / np.sqrt(2)],
    [1 / np.sqrt(2), -1 / np.sqrt(2)],
    [1 / np.sqrt(2), 1j / np.sqrt(2)],
    [1 / np.sqrt(2), -1j / np.sqrt(2)],
], dtype=np.complex64)


class RandomStabilizerStateHeuristic(_FieldsHeuristic):
    """Measure the projector onto a random product of single-qubit
    stabilizer states. Its coordinates in a Pauli basis are the Kronecker
    product of the single-qubit ones."""

    def __init__(self, updater, other_fields=None):
        super().__init__(updater, other_fields)
        basis = _model_basis(updater.model)
        if any(d != 2 for d in basis.dims):
            raise ValueError(
                "RandomStabilizerStateHeuristic requires qubit systems")
        self.nq = len(basis.dims)
        self.basis = basis
        self.stabilizer_coords = torch.tensor(
            _projector_coords(pauli_basis(1), _STABILIZER_KETS),
            dtype=torch.float32, device=self._device)  # (6, 4)

    def propose(self, generator, weights, locations, idx_exp):
        table = self.stabilizer_coords.to(locations.device)
        coords = torch.ones((1,), dtype=torch.float32,
                            device=locations.device)
        for _ in range(self.nq):
            coords = torch.kron(coords, table[_pick(generator, 6)][0])
        return self._with_fields(coords[None, :], locations.device)


class ProductHeuristic(_FieldsHeuristic):
    """Run one sub-heuristic per subsystem and measure the product effect
    (the Kronecker product of the sub-proposals' coordinates, exact for
    tensor-product bases such as ``pauli_basis(n)``).

    :param basis: the target basis.
    :param sub_heuristic_classes: one heuristic class per subsystem.
    :param sub_updaters: the updaters (on the per-subsystem bases) to bind
        them to; default: ``updater`` for each.
    """

    def __init__(self, updater, basis, sub_heuristic_classes,
                 sub_updaters=None, other_fields=None):
        super().__init__(updater, other_fields)
        self.basis = basis
        subs = sub_updaters if sub_updaters is not None else \
            [updater] * len(sub_heuristic_classes)
        self.sub_heuristics = [
            cls(u) for cls, u in zip(sub_heuristic_classes, subs)]
        prod = 1
        for h in self.sub_heuristics:
            prod *= _model_basis(h.updater.model).n_ops
        if prod != basis.n_ops:
            raise ValueError(
                f"ProductHeuristic: sub-heuristic bases combine to "
                f"{prod} coordinates but the target basis has "
                f"{basis.n_ops}; pass sub_updaters built on the "
                f"per-subsystem bases (e.g. pauli_basis(1) models)")

    def propose(self, generator, weights, locations, idx_exp):
        coords = torch.ones((1,), dtype=torch.float32,
                            device=locations.device)
        for h in self.sub_heuristics:
            sub = h.propose(generator, weights, locations, idx_exp)
            coords = torch.kron(coords, sub["meas"][0].to(locations.device))
        return self._with_fields(coords[None, :], locations.device)


class BestOfKMetaheuristic(Heuristic):
    """Draw ``k`` candidate measurements from a base heuristic (from the
    updater's generator) and keep the one with the best score, maximum
    information gain or minimum Bayes risk, all ``k`` scored in ONE engine
    call.

    :param base_heuristic: a heuristic with the pure ``propose`` form.
    :param str score: ``'information_gain'`` or ``'bayes_risk'``.
    :param other_fields: fields added to every candidate (one value, or
        one per candidate).
    """

    def __init__(self, updater, base_heuristic, k=8,
                 score="information_gain", other_fields=None):
        super().__init__(updater)
        self.base_heuristic = base_heuristic
        self.k = int(k)
        if score not in ("information_gain", "bayes_risk"):
            raise ValueError("score must be information_gain or bayes_risk")
        self.score = score
        self.other_fields = dict(other_fields or {})

    def __call__(self, idx_exp=0):
        u = self._updater
        st = u.state
        cands = [self.base_heuristic.propose(u.generator, st.weights,
                                             st.locations, idx_exp)
                 for _ in range(self.k)]
        # every field the base proposes (a base bound to a time-dependent
        # model proposes more than 'meas')
        eps = {f: torch.cat([torch.atleast_1d(c[f]) for c in cands])
               for f in cands[0]}
        for name, val in self.other_fields.items():
            val = _field(val, u.device)
            eps[name] = (val.expand((self.k,) + val.shape[1:])
                         if val.shape[0] == 1
                         else val.repeat((self.k,) + (1,) * (val.ndim - 1)
                                         )[:self.k])
        if self.score == "information_gain":
            best = int(torch.argmax(u.expected_information_gain(eps)))
        else:
            best = int(torch.argmin(u.bayes_risk(eps)))
        return {f: v[best:best + 1] for f, v in eps.items()}

    def propose(self, generator, weights, locations, idx_exp):
        raise NotImplementedError(
            "BestOfKMetaheuristic scores candidates against the updater's "
            "posterior; use the host __call__ form")
