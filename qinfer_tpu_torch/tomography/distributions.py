"""Priors over density operators (counterpart of
:mod:`qinfer_tpu.tomography.distributions`: ``DensityOperatorDistribution``,
``GinibreDistribution``, ``GinibreReditDistribution``,
``BCSZChoiDistribution`` and ``GADFLIDistribution``).

Sampling runs in the real embedding, as in the JAX package: a complex
Ginibre draw G = A + iB is the real block matrix E(G) built from two real
normal draws, GG† is E(G)E(G)ᵀ, and coordinates come out through the
basis's real trace inner products. Draws come from an explicit
:class:`torch.Generator` and land on its device.
"""

from __future__ import annotations

import torch

import numpy as np

from ..config import EPS
from ..distributions import Distribution, _DeviceCache, sample_beta
from .bases import (EMBEDDED_SWEEPS, assemble_embedding,
                    batched_jacobi_eigh_small, embed_hermitian_host)

__all__ = [
    "DensityOperatorDistribution",
    "GinibreDistribution",
    "GinibreReditDistribution",
    "BCSZChoiDistribution",
    "GADFLIDistribution",
]


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


def _normalize_trace(m, half):
    """Divide each embedded matrix by its trace (halved for the complex
    embedding, whose trace is twice Tr ρ)."""
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    if half:
        tr = 0.5 * tr
    return m / torch.clamp_min(tr, EPS)[:, None, None]


class DensityOperatorDistribution(Distribution):
    """Distribution over density operators in a tomography basis; samples
    are the ``d² − 1`` free coordinates (the trace coordinate dropped, as
    :class:`~qinfer_tpu_torch.tomography.models.TomographyModel` wants).

    Subclasses implement ``_sample_embedded(generator, n) -> (n, 2d, 2d)``:
    unit-trace density operators in the real embedding.
    """

    def __init__(self, basis):
        self.basis = basis

    @property
    def dim(self):
        return self.basis.dim

    @property
    def n_rvs(self):
        return self.basis.n_ops - 1

    def sample(self, generator, n=1):
        m = self._sample_embedded(generator, n)
        return self.basis.embedded_to_coords(m)[:, 1:].contiguous()

    def _sample_embedded(self, generator, n):
        raise NotImplementedError


class GinibreDistribution(DensityOperatorDistribution):
    """Ginibre random states of a given rank: ρ ∝ GG† with G a
    ``d × rank`` complex standard normal matrix."""

    def __init__(self, basis, rank=None):
        super().__init__(basis)
        self.rank = int(rank) if rank is not None else self.dim

    @property
    def is_flat_on_support(self):
        """Full-rank Ginibre states are the Hilbert-Schmidt measure,
        uniform over the PSD cone in the basis coordinates (density
        ∝ det(ρ)^{rank − dim}); lower ranks live on the cone's boundary
        and are no rejuvenation target."""
        return self.rank == self.dim

    def _sample_embedded(self, generator, n):
        d, r = self.dim, self.rank
        A = _normal(generator, (n, d, r))
        B = _normal(generator, (n, d, r))
        gE = assemble_embedding(A, B)  # E(G): (n, 2d, 2r)
        return _normalize_trace(gE @ gE.transpose(-1, -2), half=True)


class GinibreReditDistribution(DensityOperatorDistribution):
    """Real Ginibre states (rebits/redits): ρ ∝ GGᵀ with G real."""

    def __init__(self, basis, rank=None):
        super().__init__(basis)
        self.rank = int(rank) if rank is not None else self.dim

    def _sample_embedded(self, generator, n):
        g = _normal(generator, (n, self.dim, self.rank))
        rho = _normalize_trace(g @ g.transpose(-1, -2), half=False)
        return assemble_embedding(rho, torch.zeros_like(rho))


class BCSZChoiDistribution(DensityOperatorDistribution):
    """BCSZ-random CPTP channels as normalized Choi states: W = GG† with G
    a ``d² × rank`` complex normal matrix, made trace-preserving by
    W ↦ (S^{-1/2} ⊗ I) W (S^{-1/2} ⊗ I) with S = Tr₂ W, and normalized to
    unit trace. The basis must live on the doubled space (dim d²). The
    inverse square root of S comes from the eigendecomposition of E(S) by
    kernel K6 (:func:`~qinfer_tpu_torch.tomography.bases.
    batched_jacobi_eigh_small`), where the JAX package calls
    ``jnp.linalg.eigh``: cuSOLVER's batched ``syev`` behind
    ``torch.linalg.eigh`` refuses a batch of 50 000 8×8 matrices
    (``CUSOLVER_STATUS_INVALID_VALUE`` on an H100), and S is positive
    definite and well conditioned, so the Jacobi eigenvalues are as good
    here."""

    def __init__(self, basis, hilbert_dim=None, rank=None):
        super().__init__(basis)
        d2 = self.dim
        hd = int(hilbert_dim) if hilbert_dim is not None else int(d2 ** 0.5)
        if hd * hd != d2:
            raise ValueError(
                "BCSZChoiDistribution needs a basis on a d² space")
        self.hilbert_dim = hd
        self.rank = int(rank) if rank is not None else d2

    @property
    def is_flat_on_support(self):
        """Full Kraus-rank BCSZ channels are the flat measure on the Choi
        section of CPTP maps (Bruzda, Cappellini, Sommers and Życzkowski
        2009), so the density is constant on its support."""
        return self.rank == self.dim

    def _sample_embedded(self, generator, n):
        d = self.hilbert_dim
        d2, r = d * d, self.rank
        A = _normal(generator, (n, d2, r))
        B = _normal(generator, (n, d2, r))
        gE = assemble_embedding(A, B)           # E(G): (n, 2d², 2r)
        wE = gE @ gE.transpose(-1, -2)           # E(W): (n, 2d², 2d²)

        # partial trace over the second factor, on Re W and Im W
        w_re = wE[:, :d2, :d2].reshape(n, d, d, d, d)
        w_im = wE[:, d2:, :d2].reshape(n, d, d, d, d)
        sE = assemble_embedding(torch.einsum("nakbk->nab", w_re),
                                torch.einsum("nakbk->nab", w_im))

        ev, V = batched_jacobi_eigh_small(sE, sweeps=EMBEDDED_SWEEPS)
        inv_sqrt = (V * (1.0 / torch.sqrt(torch.clamp_min(ev, 1e-12)))
                    [:, None, :]) @ V.transpose(-1, -2)  # E(K), K = S^{-1/2}
        k_re = inv_sqrt[:, :d, :d]
        k_im = inv_sqrt[:, d:, :d]

        eye = torch.eye(d, dtype=wE.dtype, device=wE.device)
        m_re = torch.einsum("nab,cd->nacbd", k_re, eye).reshape(n, d2, d2)
        m_im = torch.einsum("nab,cd->nacbd", k_im, eye).reshape(n, d2, d2)
        mE = assemble_embedding(m_re, m_im)      # E(K ⊗ I)

        choi = mE @ wE @ mE.transpose(-1, -2)
        return _normalize_trace(choi, half=True)


class GADFLIDistribution(_DeviceCache, DensityOperatorDistribution):
    """A prior informed by a fiducial state (``qinfer_tpu/tomography/
    distributions.py:187``): ρ = (1 − β)·ρ_Ginibre + β·ρ_fiducial with
    β ~ Beta(alpha, beta), so the mass gathers near the experimenter's
    fiducial guess while every state keeps support (Granade et al.,
    NJP 18 033024, 2016). The Beta is two generator-driven Gammas.

    :param fiducial_state: the (d, d) complex fiducial density operator.
    :param rank: the Ginibre part's rank (full by default).
    """

    def __init__(self, basis, fiducial_state, alpha=1.0, beta=9.0,
                 rank=None):
        super().__init__(basis)
        self.fiducial_embedded = torch.as_tensor(
            np.asarray(embed_hermitian_host(fiducial_state)),
            dtype=torch.float32)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.rank = int(rank) if rank is not None else None

    def _sample_embedded(self, generator, n):
        rho_g = GinibreDistribution(self.basis, rank=self.rank) \
            ._sample_embedded(generator, n)
        mix = sample_beta(generator, self.alpha, self.beta, (n, 1, 1))
        fid = self._on("fiducial_embedded", generator.device)
        return (1.0 - mix) * rho_g + mix * fid[None]
