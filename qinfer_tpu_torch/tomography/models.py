"""Tomography likelihood models (counterpart of
:mod:`qinfer_tpu.tomography.models`: ``TomographyModel``,
``ProcessTomographyModel`` and ``DiffusiveTomographyModel``).

Model parameters are the ``d² − 1`` traceless coordinates of ρ in an
orthonormal basis; the Born rule is one coordinate dot product per
(particle, experiment). Validity and the PSD projection run on the real
embedding E(ρ) (:mod:`.bases`): validity is a batched Cholesky of
``E(ρ) + psd_tol·I``, and the projection is the Jacobi kernel K4
(embedded d ≤ 16) or K5 (16 < d ≤ 32), with ``torch.linalg.eigh`` and an
outside rebuild beyond. Complex arithmetic (fidelity, channel action)
stays on the host in NumPy.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..abstract_model import FiniteOutcomeModel, atleast_2d
from .. import tracing
from .._exceptions import PerformanceWarning
from ..config import DEFAULT_DEVICE, EPS
from ..ops.jacobi import jacobi_project_lanes, jacobi_project_lanes_looped
from .bases import (EMBEDDED_SWEEPS, batched_cholesky_small,
                    embed_hermitian_host)

__all__ = ["TomographyModel", "DiffusiveTomographyModel",
           "ProcessTomographyModel"]

#: jitter of the strict gate in front of the projection
STRICT_PSD_TOL = 1e-6


def _cholesky_fails(m, jitter):
    """(n,) True where ``m + jitter·I`` is not positive definite."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    L = batched_cholesky_small(m + jitter * eye)
    return torch.isnan(L).any(dim=-1).any(dim=-1)


def project_psd_embedded(m, trace=2.0):
    """PSD-cone projection of embedded states ``(n, D, D)``, rescaled to
    ``trace``: kernel K4 for D ≤ 16, K5 for 16 < D ≤ 32 (both with
    ``EMBEDDED_SWEEPS`` sweeps), and beyond that ``torch.linalg.eigh`` with
    the clip and rebuild outside."""
    D = m.shape[-1]
    if D <= 16:
        return jacobi_project_lanes(m, sweeps=EMBEDDED_SWEEPS, trace=trace,
                                    eps=EPS)
    if D <= 32:
        return jacobi_project_lanes_looped(m, sweeps=EMBEDDED_SWEEPS,
                                           trace=trace, eps=EPS)
    ev, V = torch.linalg.eigh(m)
    ev = torch.clamp_min(ev, 0.0)
    ev = trace * ev / torch.clamp_min(ev.sum(dim=-1, keepdim=True), EPS)
    return (V * ev[:, None, :]) @ V.transpose(-1, -2)


class TomographyModel(FiniteOutcomeModel):
    """Two-outcome state tomography in a fixed Hermitian operator basis.

    :param basis: a :class:`~qinfer_tpu_torch.tomography.bases.
        TomographyBasis`.
    :param bool allow_subnormalized: must be False: the trace coordinate
        is fixed by the parameterization.
    :param float psd_tol: eigenvalue tolerance of the validity check (the
        JAX package's default, kept for parity).

    ``projection_count`` counts the :meth:`canonicalize` calls that found
    a state outside the strict cone and ran the projection.
    """

    def __init__(self, basis, allow_subnormalized=False, psd_tol=2e-3):
        super().__init__()
        self.basis = basis
        if allow_subnormalized:
            raise NotImplementedError(
                "allow_subnormalized: the trace coordinate is fixed by "
                "this parameterization (only traceless coordinates are "
                "model parameters), so Tr rho < 1 states cannot be "
                "represented")
        self.allow_subnormalized = False
        self.psd_tol = float(psd_tol)
        if (2 * int(basis.dim) > 32
                and torch.device(DEFAULT_DEVICE).type == "cuda"
                and torch.cuda.is_available()):
            # past embedded d = 32 the projection leaves the Jacobi
            # kernels (K4, K5) for torch.linalg.eigh: say so before the
            # first projection, as the JAX package does on the TPU
            warnings.warn(
                f"TomographyModel with Hilbert dimension {basis.dim} "
                f"(embedded {2 * basis.dim} > 32) exceeds the Jacobi "
                f"kernels' gate: PSD projections on the card fall back to "
                f"torch.linalg.eigh (cuSOLVER)", PerformanceWarning,
                stacklevel=2)
        self.projection_count = 0
        # the fixed trace coordinate 1/√d, rounded as float32 arithmetic
        self._trace_coord = float(
            1.0 / torch.sqrt(torch.tensor(float(basis.dim))))

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_modelparams(self):
        return self.basis.n_ops - 1

    @property
    def modelparam_names(self):
        return list(self.basis.labels[1:])

    @property
    def expparams_dtype(self):
        return [("meas", "float32", self.basis.n_ops)]

    def n_outcomes(self, expparams=None):
        return 2

    # -- state reconstruction ---------------------------------------------

    def _full_coords(self, modelparams):
        """Prepend the fixed trace coordinate 1/√d."""
        modelparams = atleast_2d(modelparams)
        tr = torch.full((modelparams.shape[0], 1), self._trace_coord,
                        dtype=modelparams.dtype, device=modelparams.device)
        return torch.cat([tr, modelparams], dim=1)

    def modelparams_to_states(self, modelparams):
        """(n, d, d) complex density matrices (host NumPy)."""
        if not torch.is_tensor(modelparams):
            modelparams = torch.tensor(np.asarray(modelparams))
        return self.basis.modelparams_to_state(self._full_coords(modelparams))

    def states_to_modelparams(self, rhos):
        """Model parameters of host density matrices (CPU tensor)."""
        return self.basis.state_to_modelparams(rhos)[..., 1:]

    def _embedded_states(self, modelparams):
        """E(ρ) for a particle batch: ``(n, 2d, 2d)``."""
        return self.basis.coords_to_embedded(self._full_coords(modelparams))

    # -- Model contract ----------------------------------------------------

    def are_models_valid(self, modelparams):
        modelparams = atleast_2d(modelparams)
        if self.dim == 2:
            # qubit closed form: λ_min ≥ −tol ⇔ √2 ‖mp‖ ≤ 1 + 2 tol
            s2 = 2.0 * torch.sum(modelparams * modelparams, dim=-1)
            return s2 <= (1.0 + 2.0 * self.psd_tol) ** 2
        return ~_cholesky_fails(self._embedded_states(modelparams),
                                self.psd_tol)

    def canonicalize(self, modelparams):
        """Project onto the PSD cone: clip negative eigenvalues and
        renormalize the trace. Rows PSD within ``STRICT_PSD_TOL`` (the
        strict gate, tighter than ``psd_tol``) pass through bit-identically;
        the others are replaced by their projection. For qubits the
        projection is the Bloch-ball radial one, in closed form."""
        modelparams = atleast_2d(modelparams)
        if self.dim == 2:
            r = torch.sqrt(torch.sum(modelparams * modelparams, dim=-1,
                                     keepdim=True))
            scale = torch.clamp_max(
                1.0 / (math.sqrt(2.0) * torch.clamp_min(r, EPS)), 1.0)
            return modelparams * scale
        m = self._embedded_states(modelparams)
        invalid = _cholesky_fails(m, STRICT_PSD_TOL)
        tracing.host_read("project.verdict")
        if not bool(invalid.any()):
            return modelparams
        self.projection_count += 1
        # embedded trace is 2·Tr ρ = 2
        coords = self.basis.embedded_to_coords(project_psd_embedded(m, 2.0))
        return torch.where(invalid[:, None],
                           coords[:, 1:].to(modelparams.dtype), modelparams)

    def likelihood(self, outcomes, modelparams, expparams):
        """Born rule: Pr(0 | ρ; E) = Tr(Eρ) = e·x."""
        self._bump("_call_count")
        x = self._full_coords(modelparams)
        eps = self.canonicalize_expparams(expparams, x.device)
        meas = atleast_2d(eps["meas"])
        pr0 = torch.clamp(x @ meas.T, 0.0, 1.0)
        return self.pr0_to_likelihood_array(outcomes, pr0)

    # -- host conveniences -------------------------------------------------

    def fidelity_with(self, modelparams, sigma):
        """Uhlmann fidelity F(ρ, σ) of a particle batch against a fixed host
        state σ, in host NumPy through the real embedding. Returns a NumPy
        array (n,)."""
        mp = modelparams
        if torch.is_tensor(mp):
            mp = mp.detach().cpu().numpy()
        mp = np.atleast_2d(np.asarray(mp, dtype=np.float32))
        tr = np.full((mp.shape[0], 1), self._trace_coord, dtype=mp.dtype)
        coords = np.concatenate([tr, mp], axis=1)
        m = np.einsum("ni,iab->nab", coords,
                      self.basis.data_embedded.numpy())
        sig_e = embed_hermitian_host(sigma)
        es, vs = np.linalg.eigh(sig_e)
        sqrt_sig = np.einsum(
            "ab,b,cb->ac", vs, np.sqrt(np.clip(es, 0.0, None)), vs)
        M = np.einsum("ab,nbc,cd->nad", sqrt_sig, m, sqrt_sig)
        ev = np.linalg.eigvalsh(M)[..., ::2]
        return np.sum(np.sqrt(np.clip(ev, 0.0, None)), axis=-1) ** 2


class ProcessTomographyModel(TomographyModel):
    """Quantum process tomography: the model parameters are the free
    coordinates of a channel's normalized Choi state ρ_Λ = J(Λ)/d on the
    doubled space; an experiment prepares ρ_in and measures E, and
    ``Pr(0) = d · Tr[(ρ_inᵀ ⊗ E) ρ_Λ]``: one dot product with the effect's
    doubled-space coordinates, assembled from the ``prep`` and ``meas``
    system coordinates through the host-precomputed bilinear tensor
    ``T[k, i, j] = d · Re Tr(C_k (B_iᵀ ⊗ B_j))``.

    :param doubled_basis: basis on the d² space (e.g. ``pauli_basis(2)``
        for a single-qubit channel).
    :param system_basis: basis on the d space (e.g. ``pauli_basis(1)``).
    """

    def __init__(self, doubled_basis, system_basis, **kwargs):
        super().__init__(doubled_basis, **kwargs)
        self.system_basis = system_basis
        d = system_basis.dim
        if doubled_basis.dim != d * d:
            raise ValueError(
                "doubled_basis must act on the square of system_basis's "
                "dimension")
        self.hilbert_dim = d
        C = np.asarray(doubled_basis.data)
        Bsys = np.asarray(system_basis.data)
        BT = Bsys.transpose(0, 2, 1)
        kron = np.einsum("iab,jcd->ijacbd", BT, Bsys).reshape(
            Bsys.shape[0], Bsys.shape[0], d * d, d * d)
        T = d * np.real(np.einsum("kab,ijba->kij", C, kron))
        self.effect_tensor = torch.from_numpy(
            np.ascontiguousarray(T, dtype=np.float32))
        self._effect_on_device = {}

    @property
    def expparams_dtype(self):
        n = self.system_basis.n_ops
        return [("prep", "float32", n), ("meas", "float32", n)]

    def _effect_coords(self, eps):
        """Doubled-space coordinates of d·(ρ_inᵀ ⊗ E): (n_e, n_ops)."""
        prep = atleast_2d(eps["prep"])
        meas = atleast_2d(eps["meas"])
        dev = prep.device
        if dev not in self._effect_on_device:
            self._effect_on_device[dev] = self.effect_tensor.to(dev)
        return torch.einsum("kij,ni,nj->nk", self._effect_on_device[dev],
                            prep, meas)

    def likelihood(self, outcomes, modelparams, expparams):
        self._bump("_call_count")
        x = self._full_coords(modelparams)
        eps = self.canonicalize_expparams(expparams, x.device)
        pr0 = torch.clamp(x @ self._effect_coords(eps).T, 0.0, 1.0)
        return self.pr0_to_likelihood_array(outcomes, pr0)

    def apply_channel(self, modelparams, rho_in):
        """Λ(ρ_in) for each particle (host NumPy): Λ(ρ)_{ab} =
        Σ_{ik} ρ_{ki} J[(k a), (i b)]."""
        d = self.hilbert_dim
        choi = np.asarray(self.modelparams_to_states(modelparams))
        J4 = d * choi.reshape(-1, d, d, d, d)
        rho = np.asarray(rho_in).astype(J4.dtype)
        return np.einsum("ki,nkaib->nab", rho, J4)


class DiffusiveTomographyModel(TomographyModel):
    """Tomography of a state that diffuses between measurements:
    expparams gain a ``t`` field, and :meth:`update_timestep` adds Gaussian
    coordinate steps of scale ``diffusion_rate · √t`` and projects the
    result back onto the PSD cone."""

    def __init__(self, basis, diffusion_rate=0.01, **kwargs):
        super().__init__(basis, **kwargs)
        self.diffusion_rate = float(diffusion_rate)

    @property
    def expparams_dtype(self):
        return [("meas", "float32", self.basis.n_ops), ("t", "float32")]

    def update_timestep(self, generator, modelparams, expparams):
        modelparams = atleast_2d(modelparams)
        dev = modelparams.device
        eps = self.canonicalize_expparams(expparams, dev)
        t = eps["t"].reshape(-1) if "t" in eps else torch.ones(1, device=dev)
        n_e = t.shape[0]
        n_m, d = modelparams.shape
        steps = torch.randn((n_m, d, n_e), generator=generator, device=dev)
        scale = self.diffusion_rate * torch.sqrt(torch.clamp_min(t, 0.0))
        moved = modelparams[:, :, None] + steps * scale[None, None, :]
        return torch.stack([self.canonicalize(moved[:, :, j])
                            for j in range(n_e)], dim=2)

