"""Numerical utilities (counterpart of :mod:`qinfer_tpu.utils`: the
binomial and multinomial pmfs, multinomial draws, weighted particle
moments and mean functions, effective sample size, the PSD matrix square
root, the simplex transforms, the host-side ellipsoid geometry of the
region estimators, and the host helpers of ``qinfer_tpu/utils.py:326-391``
in the port's own copy)."""

from __future__ import annotations

import numpy as np
import torch

from .config import EPS

__all__ = ["log_binomial_pdf", "binomial_pdf", "multinomial_pdf",
           "sample_multinomial", "outer_product", "particle_mean",
           "particle_meanfn", "particle_covariance_mtx", "weighted_moments",
           "n_ess", "sqrtm_psd", "in_ellipsoid", "ellipsoid_volume", "mvee",
           "to_simplex", "from_simplex", "uniquify", "assert_sigfigs_equal",
           "format_uncertainty", "compactspace", "safe_shape",
           "join_struct_arrays"]


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


def multinomial_pdf(n, p):
    """Pr(n | p) of a multinomial: counts ``n`` (..., k), category
    probabilities ``p`` (..., k) clipped to [EPS, 1], total ``n.sum(-1)``
    (``qinfer_tpu/utils.py:81``). Summed in log space with
    :func:`torch.lgamma`, then exponentiated; the result takes ``p``'s
    floating dtype."""
    p = torch.as_tensor(p)
    if not p.is_floating_point():
        p = p.to(torch.get_default_dtype())
    n = torch.as_tensor(n, device=p.device).to(p.dtype)
    p = torch.clamp(p, EPS, 1.0)
    N = torch.sum(n, dim=-1)
    log_pmf = (torch.lgamma(N + 1.0) - torch.sum(torch.lgamma(n + 1.0), dim=-1)
               + torch.sum(n * torch.log(p), dim=-1))
    return torch.exp(log_pmf)


#: the row length of :func:`cumsum_last`'s blocked scan on the card
_SCAN_ROW = 4096


def cumsum_last(x):
    """``torch.cumsum(x, dim=-1)``, reproducible on the card. A CUDA
    cumsum over one row (``x.numel() == x.shape[-1]``) is cub's
    single-pass scan, whose decoupled look-back adds a tile's predecessors
    in an order that depends on timing, so its float sums change from run
    to run (a 10⁷-particle run's trajectory with them); that row takes
    :func:`_blocked_cumsum`. Several rows, and every CPU tensor, take
    ``torch.cumsum`` as it is."""
    n = x.shape[-1]
    if x.device.type != "cuda" or x.numel() != n or n == 0:
        return torch.cumsum(x, dim=-1)
    return _blocked_cumsum(x.reshape(n)).reshape(x.shape)


def _blocked_cumsum(flat):
    """The cumsum of a 1-D tensor as rows of ``_SCAN_ROW`` (PyTorch's
    one-block-a-row scan: a fixed order) plus the scan of the rows'
    totals, the same way; a row alone is scanned beside a copy of itself,
    since one row would go back to cub."""
    n = flat.shape[0]
    if n <= _SCAN_ROW:
        return torch.cumsum(torch.stack([flat, flat]), dim=-1)[0]
    rows = -(-n // _SCAN_ROW)
    if rows * _SCAN_ROW != n:
        flat = torch.nn.functional.pad(flat, (0, rows * _SCAN_ROW - n))
    scans = torch.cumsum(flat.view(rows, _SCAN_ROW), dim=-1)
    totals = scans[:, -1]
    scans = scans + (_blocked_cumsum(totals) - totals)[:, None]
    return scans.reshape(-1)[:n]


def sample_multinomial(generator, N, p, shape=()):
    """Multinomial count vectors ``shape + (k,)``, int32, each summing to
    ``N`` (``qinfer_tpu/utils.py:98``): ``N`` categorical draws a vector,
    each by inverse CDF on one uniform from ``generator``, counted per
    category. ``p`` is (k,), not necessarily normalized; a zero category
    is never drawn."""
    p = torch.clamp(torch.as_tensor(p, dtype=torch.float32,
                                    device=generator.device), EPS, 1.0)
    k = p.shape[-1]
    cdf = torch.cumsum(p, dim=-1)
    u = torch.rand(tuple(shape) + (int(N),), generator=generator,
                   device=generator.device)
    v = torch.minimum(u * cdf[-1], torch.nextafter(cdf[-1], cdf.new_zeros(())))
    cats = torch.searchsorted(cdf, v.contiguous(), right=True).clamp_max(k - 1)
    counts = torch.zeros(tuple(shape) + (k,), dtype=torch.int32,
                         device=generator.device)
    return counts.scatter_add_(-1, cats, torch.ones_like(cats,
                                                         dtype=torch.int32))


def outer_product(x):
    """x xᵀ of a vector x."""
    x = torch.as_tensor(x)
    return torch.outer(x, x)


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


# -- simplex transforms (multinomial-valued model parameters) ---------------

def to_simplex(y):
    """Stick-breaking coordinates (..., k−1) in (0, 1) to points of the
    probability simplex (..., k)."""
    y = torch.as_tensor(y)
    rem = torch.cat([torch.ones_like(y[..., :1]),
                     torch.cumprod(1.0 - y, dim=-1)], dim=-1)
    sticks = torch.cat([y, torch.ones_like(y[..., :1])], dim=-1)
    return rem * sticks


def from_simplex(p):
    """Inverse of :func:`to_simplex`: simplex points (..., k) to
    stick-breaking coordinates (..., k−1), clipped to [0, 1]."""
    p = torch.as_tensor(p)
    rem = 1.0 - torch.cumsum(p[..., :-1], dim=-1)
    rem = torch.cat([torch.ones_like(p[..., :1]), rem[..., :-1]], dim=-1)
    return torch.clamp(p[..., :-1] / torch.clamp_min(rem, EPS), 0.0, 1.0)


# -- host helpers ------------------------------------------------------------

def uniquify(seq):
    """The items of ``seq`` without repeats, in first-seen order."""
    seen = set()
    out = []
    for item in seq:
        if item not in seen:
            seen.add(item)
            out.append(item)
    return out


def assert_sigfigs_equal(x, y, sigfigs=3):
    """Assert that two arrays agree to ``sigfigs`` significant figures."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    mag = np.floor(np.log10(np.maximum(np.abs(x), np.abs(y)) + 1e-300))
    scale = 10.0 ** (mag - sigfigs + 1)
    np.testing.assert_array_almost_equal(x / scale, y / scale, decimal=0)


def format_uncertainty(value, uncertainty, scinotn_break=4):
    """``value ± uncertainty`` with the digits the uncertainty justifies,
    e.g. ``format_uncertainty(0.12345, 0.002)`` → ``'0.123 ± 0.002'``;
    scientific notation relative to the value's magnitude when either
    magnitude reaches ``scinotn_break``."""
    value = float(value)
    uncertainty = float(uncertainty)
    if uncertainty <= 0 or not np.isfinite(uncertainty):
        return "{0}".format(value)
    mag_unc = int(np.floor(np.log10(uncertainty)))
    mag_val = int(np.floor(np.log10(abs(value)))) if value != 0 else 0
    if abs(mag_val) < scinotn_break and abs(mag_unc) < scinotn_break:
        digits = max(0, -mag_unc)
        return "{0:.{d}f} ± {1:.{d}f}".format(value, uncertainty, d=digits)
    scaled_val = value / 10.0 ** mag_val
    scaled_unc = uncertainty / 10.0 ** mag_val
    digits = max(0, mag_val - mag_unc)
    return "({0:.{d}f} ± {1:.{d}f}) × 10^{2}".format(
        scaled_val, scaled_unc, mag_val, d=digits)


def compactspace(scale, n):
    """``n`` points spanning the real line, compactified by arctanh (for
    plotting the marginals of unbounded parameters)."""
    interior = np.linspace(-1.0, 1.0, n + 2)[1:-1]
    return scale * np.arctanh(interior)


def safe_shape(arr, idx=0, default=1):
    """``arr.shape[idx]`` if the array has that axis, else ``default``."""
    shape = np.shape(arr)
    return shape[idx] if len(shape) > idx else default


def join_struct_arrays(arrays):
    """NumPy structured arrays of one length joined field-wise into one
    structured array."""
    dtype = sum((a.dtype.descr for a in arrays), [])
    out = np.empty(len(arrays[0]), dtype=dtype)
    for a in arrays:
        for name in a.dtype.names:
            out[name] = a[name]
    return out
