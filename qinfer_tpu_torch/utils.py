"""Numerical utilities on the SMC main path (counterpart of
:mod:`qinfer_tpu.utils`: the binomial pmf, weighted particle moments,
effective sample size and the PSD matrix square root)."""

from __future__ import annotations

import torch

from .config import EPS

__all__ = ["log_binomial_pdf", "binomial_pdf", "particle_mean",
           "particle_covariance_mtx", "weighted_moments", "n_ess",
           "sqrtm_psd"]


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
