"""Numerical utilities (counterpart of :mod:`qinfer_tpu.utils`: the
binomial pmf, weighted particle moments and mean functions, effective
sample size, the PSD matrix square root, and the host-side ellipsoid
geometry of the region estimators)."""

from __future__ import annotations

import numpy as np
import torch

from .config import EPS

__all__ = ["log_binomial_pdf", "binomial_pdf", "particle_mean",
           "particle_meanfn", "particle_covariance_mtx", "weighted_moments",
           "n_ess", "sqrtm_psd", "in_ellipsoid", "ellipsoid_volume", "mvee"]


def log_binomial_pdf(N, n, p):
    """log Pr(n | N, p) of a binomial distribution, numerically stable.

    All arguments broadcast; the result takes ``p``'s floating dtype.
    Interior ``p`` is clipped to ``[EPS, 1 − 1e-7]`` so gradients stay
    finite, but exactly impossible outcomes (successes at p ≤ 0, failures
    at p ≥ 1) return ``−inf``: the engine's zero-weight policy detects an
    outcome impossible for every particle as a non-finite weighted maximum
    (``smc._reweight``).
    """
    p = torch.as_tensor(p)
    if not p.is_floating_point():
        p = p.to(torch.get_default_dtype())
    N = torch.as_tensor(N, device=p.device).to(p.dtype)
    n = torch.as_tensor(n, device=p.device).to(p.dtype)
    pc = torch.clamp(p, EPS, 1.0 - 1e-7)
    log_comb = (torch.lgamma(N + 1.0) - torch.lgamma(n + 1.0)
                - torch.lgamma(N - n + 1.0))
    logp = log_comb + n * torch.log(pc) + (N - n) * torch.log1p(-pc)
    impossible = ((p <= 0.0) & (n > 0)) | ((p >= 1.0) & (n < N))
    return torch.where(impossible, -torch.inf, logp)


def binomial_pdf(N, n, p):
    """Pr(n | N, p): trials, successes, success probability."""
    return torch.exp(log_binomial_pdf(N, n, p))


def particle_mean(weights, locations):
    """Weighted mean Σᵢ wᵢ xᵢ: (n,), (n, d) → (d,)."""
    return weights @ locations


def _map_leaves(fn, tree):
    """``fn`` applied to every tensor of a tensor, tuple, list or dict."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def particle_meanfn(weights, locations, fn=None):
    """Weighted mean Σᵢ wᵢ f(xᵢ) of ``fn`` over the particles.

    ``fn`` maps ONE (d,) location to a tensor, or a tuple, list or dict of
    tensors; it is vectorized over the particle axis with
    :func:`torch.func.vmap` and the result keeps its structure. Without
    ``fn``, the weighted mean of the locations.
    """
    if fn is None:
        return particle_mean(weights, locations)
    fx = torch.func.vmap(fn)(locations)
    return _map_leaves(lambda leaf: torch.tensordot(weights, leaf, dims=1),
                       fx)


def weighted_moments(weights, locations):
    """(mean, covariance) of a weighted particle cloud, the covariance as
    the plain weighted second central moment Σᵢ wᵢ (xᵢ−μ)(xᵢ−μ)ᵀ."""
    mu = weights @ locations
    xc = locations - mu[None, :]
    cov = (xc * weights[:, None]).T @ xc
    return mu, cov


def particle_covariance_mtx(weights, locations):
    """Weighted covariance Σᵢ wᵢ (xᵢ−μ)(xᵢ−μ)ᵀ (no Bessel correction)."""
    return weighted_moments(weights, locations)[1]


def n_ess(weights):
    """Effective sample size 1 / Σ wᵢ² of normalized weights."""
    return 1.0 / torch.sum(weights * weights)


def sqrtm_psd(A, eps=1e-12):
    """Symmetric PSD matrix square root by eigendecomposition, with the
    eigenvalues clipped below at ``eps``."""
    A = 0.5 * (A + A.T)
    evals, evecs = torch.linalg.eigh(A)
    evals = torch.clamp_min(evals, eps)
    return (evecs * torch.sqrt(evals)[None, :]) @ evecs.T


# -- ellipsoids and the MVEE: host float64 NumPy, as in the JAX package ------

def in_ellipsoid(x, A, c):
    """True where points ``x`` (..., d) lie inside the ellipsoid
    (x−c)ᵀ A⁻¹ (x−c) ≤ 1 (``A`` is the shape matrix)."""
    x = np.asarray(x)
    A = np.asarray(A)
    c = np.asarray(c)
    d = x - c
    sol = np.linalg.solve(A, d[..., :, None])[..., 0]
    return np.einsum("...i,...i->...", d, sol) <= 1.0 + 1e-9


def ellipsoid_volume(A=None, invA=None):
    """Volume of the ellipsoid xᵀ A⁻¹ x ≤ 1, given ``A`` or its inverse."""
    import scipy.special as sp

    if invA is None and A is None:
        raise ValueError("Must specify either A or invA.")
    if invA is None:
        invA = np.linalg.inv(np.asarray(A))
    d = invA.shape[0]
    unit_ball = np.pi ** (d / 2.0) / sp.gamma(d / 2.0 + 1.0)
    return unit_ball / np.sqrt(np.linalg.det(invA))


def mvee(points, tol=1e-3, max_iter=10_000):
    """Khachiyan's algorithm for the minimum-volume enclosing ellipsoid of
    a point set: ``(A, c)`` with the ellipsoid {x : (x−c)ᵀ A (x−c) ≤ 1}.
    Host float64; it runs on the hull's vertices once per region query."""
    points = np.asarray(points, dtype=np.float64)
    N, d = points.shape
    Q = np.column_stack((points, np.ones(N))).T  # (d+1, N)

    u = np.full(N, 1.0 / N)
    err = tol + 1.0
    it = 0
    while err > tol and it < max_iter:
        X = Q @ np.diag(u) @ Q.T
        M = np.einsum("ij,ji->i", Q.T, np.linalg.solve(X, Q))
        j = int(np.argmax(M))
        step = (M[j] - d - 1.0) / ((d + 1.0) * (M[j] - 1.0))
        new_u = (1.0 - step) * u
        new_u[j] += step
        err = np.linalg.norm(new_u - u)
        u = new_u
        it += 1

    c = points.T @ u
    A = (
        np.linalg.inv(points.T @ np.diag(u) @ points - np.outer(c, c)) / d
    )
    return A, c
