"""Numerical utilities on the SMC main path (counterpart of
:mod:`qinfer_tpu.utils`: weighted particle moments, effective sample size
and the PSD matrix square root)."""

from __future__ import annotations

import torch

__all__ = ["particle_mean", "particle_covariance_mtx", "weighted_moments",
           "n_ess", "sqrtm_psd"]


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
