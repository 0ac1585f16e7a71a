"""The plain SMC step of the reference: reweighting, the ESS gate, the
moments, systematic ancestors and the Liu-West proposals.

Written from the algorithms' published descriptions (Liu and West 2001;
Granade et al., New J. Phys. 14, 103013 (2012)), in plain PyTorch; it
imports nothing of the program. ``total`` sums a partial over the ranks of
a cell that spans several cards (the identity in one process), so each
function here works on one rank's rows and returns what the whole ensemble
gives.
"""

from __future__ import annotations

import math

import torch


def one_process(x):
    return x


def reweight(w, lik, ar, total=one_process):
    """Bayes' rule on one outcome: ``(posterior weights, ESS)``, the weights
    normalized over the whole ensemble."""
    hyp = ar.mul(w, lik)
    norm = total(hyp.sum())
    new_w = hyp / norm
    ess = 1.0 / total((new_w * new_w).sum())
    return new_w, ess


def moments(w, x, ar, total=one_process):
    """Weighted mean (d,) and covariance (d, d) of the cloud."""
    mu = total(ar.mm(w[None, :], x)[0])
    xc = x - mu[None, :]
    cov = total(ar.mm((xc * w[:, None]).T, xc))
    return mu, cov


def systematic_counts(w, u):
    """Copies of each particle under systematic resampling with offset
    ``u`` in [0, 1): ``m_i = ⌈n·F_i − u⌉ − ⌈n·F_{i−1} − u⌉``, F the CDF of
    the (normalized) weights. Σ m = n."""
    n = w.shape[0]
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    upper = torch.ceil(n * cdf - u).clamp(0, n)
    upper[-1] = n
    lower = torch.cat([torch.zeros(1, dtype=upper.dtype, device=w.device),
                       upper[:-1]])
    return (upper - lower).to(torch.int64)


def factor(cov):
    """``L`` with ``L Lᵀ = cov`` (float64): the Cholesky factor, or the
    symmetric square root with negative eigenvalues clipped where the
    Cholesky factorization fails (any such L gives the same proposals'
    law)."""
    cov = cov.to(torch.float64)
    L, info = torch.linalg.cholesky_ex(cov)
    if int(info) == 0 and bool(torch.isfinite(L).all()):
        return L
    lam, V = torch.linalg.eigh(0.5 * (cov + cov.T))
    return V * lam.clamp_min(0.0).sqrt()[None, :]


def liu_west(generator, w, x, a, maxiter, valid, canonical, ar,
             zero_cov=1e-10):
    """One Liu-West resample in one process: systematic ancestors, the
    proposals ``a·x_anc + (1 − a)·μ + h·L·z`` (``L Lᵀ = Σ``), at most
    ``maxiter`` redraw rounds for slots that ``valid`` rejects (slots still
    invalid keep their ancestor), then ``canonical`` on the result.
    Returns the new locations (weights are uniform)."""
    n, d = x.shape
    h = math.sqrt(max(1.0 - a * a, 0.0))
    mu, cov = moments(w, x, ar)
    cov = cov + zero_cov * torch.eye(d, dtype=cov.dtype, device=cov.device)
    L = factor(cov).to(ar.dtype)
    u = torch.rand((), generator=generator, device=x.device,
                   dtype=torch.float64)
    m = systematic_counts(w.to(torch.float64), u)
    x_anc = torch.repeat_interleave(x, m, dim=0)
    centers = a * x_anc + (1.0 - a) * mu[None, :]

    def propose():
        z = torch.randn((n, d), generator=generator, device=x.device,
                        dtype=ar.dtype)
        return centers + ar.mm(z, (h * L).T)

    new = propose()
    ok = valid(new)
    for _ in range(maxiter):
        if bool(ok.all()):
            break
        fresh = propose()
        fresh_ok = valid(fresh)
        take = ~ok & fresh_ok
        new = torch.where(take[:, None], fresh, new)
        ok = ok | fresh_ok
    new = torch.where(ok[:, None], new, x_anc)
    return canonical(new)


def ks_distance(cdf_emp, cdf_law):
    return float(torch.max(torch.abs(cdf_emp - cdf_law)))
