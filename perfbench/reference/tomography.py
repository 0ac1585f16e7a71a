"""Plain reference of process tomography (QInfer's ``tomography``; Granade,
Combes and Cory, New J. Phys. 18, 033024 (2016)).

A state is ρ = Σ_k x_k C_k over the normalized Pauli basis of the doubled
space (all tensor products of {I, X, Y, Z}/√2 in that order, identity
first); the model parameters are the coordinates after the identity's,
which is fixed at 1/√D. An experiment prepares a pure ρ_in and measures
the projector E of a pure state, and Pr(0) =
d·Tr[(ρ_inᵀ ⊗ E) ρ] = e · x̄ with e_k = d·Re Tr[C_k (ρ_inᵀ ⊗ E)] and x̄ the
full coordinates. A state is valid when its least eigenvalue is at least
−``psd_tol``; the strict projection clips the eigenvalues of a state
below −``strict_tol`` at 0 and rescales them to trace 1.
"""

from __future__ import annotations

import itertools
import math
from functools import reduce

import numpy as np
import torch

from .smc import factor, liu_west

_PAULI = [np.eye(2), np.array([[0, 1], [1, 0]]),
          np.array([[0, -1j], [1j, 0]]), np.array([[1, 0], [0, -1]])]
#: states a block for the eigensolvers
_BLOCK = 8192
#: the floor of a probability inside a logarithm
_FLOOR = 1e-37


def pauli_ops(nq):
    """(4^nq, 2^nq, 2^nq) complex128: the normalized Pauli products."""
    ops = [reduce(np.kron, combo, np.eye(1)) / np.sqrt(2.0 ** nq)
           for combo in itertools.product(_PAULI, repeat=nq)]
    return np.stack(ops).astype(np.complex128)


class Process:
    """A ``qubits``-qubit channel's Choi state, on ``device``."""

    def __init__(self, qubits, psd_tol, strict_tol, device):
        self.d = 2 ** qubits
        self.D = self.d * self.d
        self.dbl = pauli_ops(2 * qubits)
        self.psd_tol = float(psd_tol)
        self.strict_tol = float(strict_tol)
        self.device = device
        self.C = torch.from_numpy(self.dbl).to(device)

    def pool_effects(self, kets):
        """(m², D²) effect coordinates of every (preparation, measurement)
        pair of the pure states ``kets`` (m of them), row i·m + j
        preparing ket i and measuring ket j."""
        proj = [np.outer(k, np.conj(k)).astype(np.complex128) for k in kets]
        op = np.stack([np.kron(r.T, e) for r in proj for e in proj])
        coords = self.d * np.real(np.einsum("kab,mba->mk", self.dbl, op))
        return torch.from_numpy(coords).to(self.device)

    def coords(self, rho):
        """The model parameters (D² − 1,) of a density matrix ``rho``."""
        rho = torch.as_tensor(np.asarray(rho, np.complex128)).to(self.device)
        return torch.real(torch.einsum("kab,ba->k", self.C, rho))[1:]

    def full(self, x, ar):
        tr = torch.full((x.shape[0], 1), 1.0 / np.sqrt(self.D),
                        dtype=ar.dtype, device=x.device)
        return torch.cat([tr, ar.cast(x)], dim=1)

    def pr0(self, x, e, ar):
        """(n, m) Pr(0) of each particle under each effect (m, D²)."""
        return torch.clamp(ar.mm(self.full(x, ar), ar.cast(e).T), 0.0, 1.0)

    def states(self, x):
        """(n, D, D) complex128 density matrices."""
        full = self.full(x, _F64)
        return torch.einsum("nk,kab->nab", full.to(torch.complex128), self.C)

    def least_eig(self, x):
        """(n,) float64 least eigenvalue of each state."""
        out = [torch.linalg.eigvalsh(self.states(x[i:i + _BLOCK]))[:, 0]
               for i in range(0, x.shape[0], _BLOCK)]
        return torch.cat(out)

    def valid(self, x):
        return self.least_eig(x) >= -self.psd_tol

    def project(self, x, ar):
        """The strict projection of the states below −``strict_tol``;
        the others as they are. The rebuild V·diag(λ)·V† is the product
        the control takes in TF32."""
        out = []
        for i in range(0, x.shape[0], _BLOCK):
            xb = x[i:i + _BLOCK]
            rho = self.states(xb)
            lam, V = torch.linalg.eigh(rho)
            bad = lam[:, 0] < -self.strict_tol
            if not bool(bad.any()):
                out.append(xb)
                continue
            lam = lam.clamp_min(0.0)
            lam = lam / lam.sum(dim=1, keepdim=True)
            Vl = V * lam[:, None, :].to(V.dtype)
            Vh = V.conj().transpose(1, 2)
            re = (ar.mm(Vl.real, Vh.real) - ar.mm(Vl.imag, Vh.imag))
            im = (ar.mm(Vl.real, Vh.imag) + ar.mm(Vl.imag, Vh.real))
            proj = torch.complex(re.to(torch.float64), im.to(torch.float64))
            coords = torch.real(torch.einsum("kab,nba->nk", self.C, proj))
            xb_new = coords[:, 1:].to(xb.dtype)
            out.append(torch.where(bad[:, None], xb_new, xb))
        return torch.cat(out)

    def record_loglik(self, x, succ, trials, pool_e, ar):
        """(n,) log-likelihood of the record kept as successes ``succ`` and
        trials ``trials`` (E,) at the pool's effects (E, D²), up to the
        binomial coefficients."""
        p = self.pr0(x, pool_e, ar)
        lp = torch.log(p.clamp_min(_FLOOR))
        lq = torch.log((1.0 - p).clamp_min(_FLOOR))
        s = succ.to(ar.dtype)
        f = (trials - succ).to(ar.dtype)
        return ar.mm(lp, s[:, None])[:, 0] + ar.mm(lq, f[:, None])[:, 0]

    def likelihood(self, x, e, outcome, shots, ar):
        """(n,) likelihood of one outcome: a bit (``shots`` 0; 0 is the
        effect E) or a count of successes of ``shots`` shots, up to its
        binomial coefficient."""
        p = self.pr0(x, e[None, :], ar)[:, 0]
        if shots == 0:
            return p if int(outcome) == 0 else 1.0 - p
        k = int(outcome)
        return p ** k * (1.0 - p) ** (shots - k)

    def resample(self, generator, w, x, a, maxiter, ar):
        """The control's Liu-West resample with the strict projection."""
        return liu_west(generator, ar.cast(w), ar.cast(x), a, maxiter,
                        self.valid, lambda y: self.project(y, ar), ar)

    def moves(self, generator, x, loglik, sweeps, log_scale, adapt_t,
              rule, ar):
        """``sweeps`` Metropolis sweeps of the random walk ``x + s·L·ξ``
        (``L Lᵀ`` the cloud's covariance) on the flat prior over valid
        states times exp(``loglik``), with s = exp(log scale) moved after
        each sweep by the Robbins-Monro ``rule`` (``target``, ``gain0``,
        ``kappa``, ``floor``, ``bounds``) from ``log_scale`` at sweep count
        ``adapt_t``. Returns ``(x, the sweeps' mean acceptance)``."""
        x = ar.cast(x)
        n, d = x.shape
        xc = x.to(torch.float64) - x.to(torch.float64).mean(dim=0,
                                                             keepdim=True)
        cov = (xc.T @ xc) / n
        L = factor(cov + 1e-10 * torch.eye(
            d, dtype=cov.dtype, device=cov.device)).to(ar.dtype)
        lp = loglik(x)
        ls, t, acc_sum = float(log_scale), int(adapt_t), 0.0
        lo, hi = rule["bounds"]
        for _ in range(int(sweeps)):
            xi = torch.randn((n, d), generator=generator, device=x.device,
                             dtype=ar.dtype)
            prop = x + math.exp(ls) * ar.mm(xi, L.T)
            lp_p = loglik(prop)
            u = torch.rand((n,), generator=generator, device=x.device,
                           dtype=torch.float64)
            take = self.valid(prop) & (torch.log(u) < (lp_p - lp)
                                        .to(torch.float64))
            x = torch.where(take[:, None], prop, x)
            lp = torch.where(take, lp_p, lp)
            acc = float(take.to(torch.float64).mean())
            acc_sum += acc
            gain = max(rule["gain0"] / (1.0 + t) ** rule["kappa"],
                       rule["floor"])
            ls = min(max(ls + gain * (acc - rule["target"]), lo), hi)
            t += 1
        return x, acc_sum / max(int(sweeps), 1)


class _Float64:
    dtype = torch.float64

    @staticmethod
    def cast(x):
        return x.to(torch.float64)


_F64 = _Float64()
