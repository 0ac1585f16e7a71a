"""Hermitian operator bases for tomography (counterpart of
:mod:`qinfer_tpu.tomography.bases`).

Bases are orthonormal under the Hilbert-Schmidt inner product, with the
first element ``I/√d``, so a unit-trace state has fixed first coordinate
``1/√d`` and the remaining ``d² − 1`` coordinates are the model
parameters.

As in the JAX package, complex numbers stay on the host in NumPy: a
complex Hermitian H maps to the real symmetric embedding
``E(H) = [[Re H, −Im H], [Im H, Re H]]`` (an algebra homomorphism whose
spectrum is H's with every eigenvalue twice), and every tensor
computation runs on the embedded real matrices.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..ops.jacobi import jacobi_eigh_lanes

__all__ = [
    "EMBEDDED_SWEEPS",
    "TomographyBasis",
    "pauli_basis",
    "gell_mann_basis",
    "tensor_product_basis",
    "batched_cholesky_small",
    "batched_jacobi_eigh_small",
    "assemble_embedding",
    "embed_hermitian",
    "embed_hermitian_host",
    "unembed_hermitian",
    "hermitian_eigvalsh",
    "hermitian_eigh_embedded",
]


#: Jacobi sweeps for embedded Hermitian matrices. Every eigenvalue of an
#: embedding comes twice, and with exact pairs the round-robin schedule's
#: default of 6 sweeps leaves a tail of matrices unconverged: the PSD
#: projection of Liu-West-pushed Ginibre and BCSZ states (plain version,
#: 3000 of each) came within 5.7e-6 / 8.4e-6 / 1.05e-5 of float64 at
#: embedded d = 8 / 16 / 32 after 6 sweeps, and within 1.2e-6 / 1.0e-6 /
#: 8.5e-7 after 8.
EMBEDDED_SWEEPS = 8


def assemble_embedding(re, im):
    """``E(A + iB) = [[A, −B], [B, A]]`` for batched real blocks
    ``(..., d, d)``."""
    top = torch.cat([re, -im], dim=-1)
    bot = torch.cat([im, re], dim=-1)
    return torch.cat([top, bot], dim=-2)


def embed_hermitian_host(mat):
    """Host embedding of a complex NumPy matrix: a real float32 NumPy
    array."""
    mat = np.asarray(mat, dtype=np.complex64)
    return np.block([[mat.real, -mat.imag],
                     [mat.imag, mat.real]]).astype(np.float32)


def embed_hermitian(rho):
    """(..., d, d) complex Hermitian (a tensor or a NumPy array) → its
    (..., 2d, 2d) real symmetric embedding, a tensor."""
    rho = torch.as_tensor(rho)
    return assemble_embedding(rho.real, rho.imag)


def unembed_hermitian(m, d):
    """Inverse of the embedding (symmetrized block read-off), as a complex
    NumPy array: ``m`` (..., 2d, 2d) tensor or array."""
    m = m.detach().cpu().numpy() if torch.is_tensor(m) else np.asarray(m)
    re = 0.5 * (m[..., :d, :d] + m[..., d:, d:])
    im = 0.5 * (m[..., d:, :d] - m[..., :d, d:])
    return (re + 1j * im).astype(np.complex64)


def hermitian_eigvalsh(rho):
    """Eigenvalues (ascending, (..., d)) of complex Hermitian matrices
    through the real embedding, whose spectrum holds each eigenvalue
    twice: the sorted duplicates are decimated."""
    return torch.linalg.eigvalsh(embed_hermitian(rho))[..., ::2]


def hermitian_eigh_embedded(rho, transform):
    """Apply an elementwise spectral ``transform`` (e.g. clipping) to a
    batch of complex Hermitian matrices entirely in the real embedding:
    the matrices with eigenvalues ``transform(eigenvalues)``, as complex
    NumPy (:func:`unembed_hermitian`)."""
    d = rho.shape[-1]
    ev, V = torch.linalg.eigh(embed_hermitian(rho))
    m2 = torch.einsum("...ab,...b,...cb->...ac", V, transform(ev), V)
    return unembed_hermitian(m2, d)


def batched_cholesky_small(a):
    """Cholesky factor of a batch of small symmetric matrices (..., d, d)
    with the JAX package's contract: a matrix that is not positive definite
    gives a factor full of NaN. ``cholesky_ex`` reports a failed pivot in
    ``info`` but may also return NaN factors with ``info == 0`` for a NaN
    input, so both count as invalid."""
    L, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0) | torch.isnan(L).any(dim=-1).any(dim=-1)
    return torch.where(bad[..., None, None], torch.nan, L)


def batched_jacobi_eigh_small(a, sweeps=6):
    """Eigendecomposition of a batch of small symmetric matrices
    ``(..., d, d)`` by parallel-ordered cyclic Jacobi (kernel K6,
    :func:`~qinfer_tpu_torch.ops.jacobi.jacobi_eigh_lanes`; its plain
    version for a tensor on the CPU). Odd d is padded with a decoupled
    unit diagonal slot.

    :return: ``(ev, V)`` with ``a ≈ V diag(ev) Vᵀ``, eigenvalues unsorted.
    """
    d = a.shape[-1]
    if d % 2:
        a_p = torch.nn.functional.pad(a, (0, 1, 0, 1))
        a_p[..., d, d] = 1.0
        ev, V = batched_jacobi_eigh_small(a_p, sweeps)
        return ev[..., :d], V[..., :d, :d]
    batch = a.shape[:-2]
    ev, V = jacobi_eigh_lanes(a.reshape((-1, d, d)).contiguous(),
                              sweeps=sweeps)
    return ev.reshape(batch + (d,)), V.reshape(batch + (d, d))


class TomographyBasis:
    """An orthonormal Hermitian operator basis.

    :param data: complex array ``(n_ops, d, d)`` of Hermitian operators,
        orthonormal under Hilbert-Schmidt; ``data[0]`` must be ``I/√d``.
    :param dims: subsystem dimensions (e.g. ``[2, 2]`` for two qubits).
    :param labels: operator names.

    ``data`` stays a host NumPy array; ``data_embedded`` is the real
    ``(n_ops, 2d, 2d)`` float32 tensor every device computation uses
    (:meth:`embedded` gives it on a device, copied once per device).
    """

    def __init__(self, data, dims, labels=None):
        host = np.ascontiguousarray(np.asarray(data, dtype=np.complex64))
        self._data = host
        self.dims = list(int(d) for d in dims)
        self.labels = list(labels) if labels is not None else [
            f"B{i}" for i in range(host.shape[0])]
        re, im = host.real, host.imag
        self.data_embedded = torch.from_numpy(np.concatenate(
            [np.concatenate([re, -im], axis=-1),
             np.concatenate([im, re], axis=-1)], axis=-2).astype(np.float32))
        self._on_device = {}

    @property
    def data(self):
        """Complex basis operators (host NumPy)."""
        return self._data

    @property
    def dim(self):
        """Total Hilbert-space dimension."""
        return int(np.prod(self.dims))

    @property
    def n_ops(self):
        return self._data.shape[0]

    def __len__(self):
        return self.n_ops

    def __getitem__(self, idx):
        return self._data[idx]

    def embedded(self, device):
        """``data_embedded`` on ``device``."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = self.data_embedded.to(device)
        return self._on_device[device]

    # -- coordinates (host) -------------------------------------------------

    def state_to_modelparams(self, rho):
        """Coordinates ``x_i = Tr(B_i ρ)`` of (a batch of) host Hermitian
        matrices, as a float32 CPU tensor ``(..., n_ops)``."""
        rho = np.asarray(rho, dtype=np.complex64)
        return torch.from_numpy(np.ascontiguousarray(
            np.real(np.einsum("iab,...ba->...i", self._data, rho))))

    def modelparams_to_state(self, x):
        """Inverse: coordinates ``(..., n_ops)`` to complex matrices
        ``(..., d, d)`` (host NumPy)."""
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
        x = np.asarray(x, dtype=np.complex64)
        return np.einsum("...i,iab->...ab", x, self._data)

    # -- real-embedded coordinates (the tensor path) ------------------------

    def coords_to_embedded(self, x):
        """Coordinates ``(..., n_ops)`` → embedded matrices
        ``(..., 2d, 2d)``: ``E(ρ) = Σ xᵢ E(Bᵢ)``."""
        E = self.embedded(x.device)
        m = x.to(torch.float32) @ E.reshape(self.n_ops, -1)
        return m.reshape(x.shape[:-1] + E.shape[1:])

    def embedded_to_coords(self, m):
        """Inverse of :meth:`coords_to_embedded` for embedded Hermitian
        matrices: ``xᵢ = ½ Tr(E(Bᵢ) E(ρ))``."""
        E = self.embedded(m.device)
        mt = m.to(torch.float32).transpose(-1, -2)
        flat = mt.reshape(m.shape[:-2] + (-1,))
        return 0.5 * (flat @ E.reshape(self.n_ops, -1).T)

    def covariance_mtx_to_superop(self, cov):
        """Lift a coordinate covariance matrix to a superoperator on
        operators, ``Σ_ij cov_ij B_i ⊗ B_j`` as a (d, d, d, d) complex host
        array (for plots)."""
        cov = cov.detach().cpu().numpy() if torch.is_tensor(cov) else cov
        cov = np.asarray(cov, dtype=np.complex64)
        return np.einsum("ij,iab,jcd->abcd", cov, self._data, self._data)

    def __repr__(self):
        return (f"<TomographyBasis dims={self.dims} "
                f"n_ops={self.n_ops} labels={self.labels[:4]}...>")


def _pauli_matrices():
    I = np.eye(2, dtype=np.complex64)
    X = np.array([[0, 1], [1, 0]], dtype=np.complex64)
    Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex64)
    Z = np.array([[1, 0], [0, -1]], dtype=np.complex64)
    return [I, X, Y, Z]


def pauli_basis(nq=1):
    """Normalized Pauli basis on ``nq`` qubits: all tensor products of
    {I, X, Y, Z}/√2, identity first."""
    paulis = _pauli_matrices()
    names = ["I", "X", "Y", "Z"]
    ops, labels = [], []
    for combo in itertools.product(range(4), repeat=nq):
        op = np.array([[1.0]], dtype=np.complex64)
        for c in combo:
            op = np.kron(op, paulis[c])
        ops.append(op / np.sqrt(2.0 ** nq))
        labels.append("".join(names[c] for c in combo))
    return TomographyBasis(np.stack(ops), [2] * nq, labels)


def gell_mann_basis(dim):
    """Normalized generalized Gell-Mann basis for one ``dim``-level system,
    identity first."""
    ops = [np.eye(dim, dtype=np.complex64) / np.sqrt(dim)]
    labels = ["I"]
    for i in range(dim):
        for j in range(i + 1, dim):
            m = np.zeros((dim, dim), dtype=np.complex64)
            m[i, j] = m[j, i] = 1.0 / np.sqrt(2.0)
            ops.append(m)
            labels.append(f"S{i}{j}")
    for i in range(dim):
        for j in range(i + 1, dim):
            m = np.zeros((dim, dim), dtype=np.complex64)
            m[i, j] = -1j / np.sqrt(2.0)
            m[j, i] = 1j / np.sqrt(2.0)
            ops.append(m)
            labels.append(f"A{i}{j}")
    for k in range(1, dim):
        m = np.zeros((dim, dim), dtype=np.complex64)
        for i in range(k):
            m[i, i] = 1.0
        m[k, k] = -float(k)
        m /= np.sqrt(k * (k + 1))
        ops.append(m)
        labels.append(f"D{k}")
    return TomographyBasis(np.stack(ops), [dim], labels)


def tensor_product_basis(*bases):
    """Tensor product of operator bases, with the identity-proportional
    element moved to index 0 and its phase fixed so ``data[0] = +I/√d``."""
    datas = [np.asarray(b.data) for b in bases]
    dims = sum((b.dims for b in bases), [])
    ops, labels = [], []
    for combo in itertools.product(*[range(d.shape[0]) for d in datas]):
        op = np.array([[1.0]], dtype=np.complex64)
        lab = []
        for b_idx, o_idx in enumerate(combo):
            op = np.kron(op, datas[b_idx][o_idx])
            lab.append(bases[b_idx].labels[o_idx])
        ops.append(op)
        labels.append("⊗".join(lab))
    ops = np.stack(ops)
    d = ops.shape[-1]
    eye = np.eye(d, dtype=np.complex64)
    id_idx = None
    for i, op in enumerate(ops):
        tr = np.trace(op)
        if abs(tr) > 1e-6 and np.allclose(op, (tr / d) * eye, atol=1e-5):
            id_idx = i
            break
    if id_idx is None:
        raise ValueError(
            "tensor_product_basis: no identity-proportional element found; "
            "input bases must each contain an identity-proportional op")
    order = [id_idx] + [i for i in range(len(ops)) if i != id_idx]
    ops = ops[order]
    labels = [labels[i] for i in order]
    tr0 = np.trace(ops[0])
    ops[0] = ops[0] * (abs(tr0) / tr0)
    return TomographyBasis(ops, dims, labels)
