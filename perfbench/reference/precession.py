"""Plain reference of the precession model (QInfer's
``SimplePrecessionModel``): Pr(0 | ω; t) = cos²(ω·t/2), ω ≥ 0 valid; the
law of its Liu-West resample; its expected information gain.
"""

from __future__ import annotations

import math

import torch

from .smc import liu_west

#: particles a block when a table over particles and grid points is built
_BLOCK = 1 << 18


def likelihood(omega, t, outcome, ar):
    """(n,) likelihood of ``outcome`` (0 or 1) at time ``t`` (a float)."""
    half_t = torch.full_like(omega, 0.5 * float(t), dtype=ar.dtype)
    p0 = torch.cos(ar.mul(omega, half_t)) ** 2
    return p0 if int(outcome) == 0 else 1.0 - p0


def valid(x):
    return x[:, 0] >= 0.0


def _phi(z):
    return 0.5 * torch.erfc(-z / math.sqrt(2.0))


def liu_west_cdf(grid, w, x, mu, var, a, maxiter, zero_cov=1e-10):
    """This rank's part of the CDF, at ``grid`` (G,), of one Liu-West
    resample of the cloud (``w`` (n,) normalized over the whole ensemble,
    ``x`` (n, 1)) whose moments are ``mu`` and ``var``: component i is the
    normal of mean ``a·x_i + (1 − a)·μ`` and sd ``h·√(var + zero_cov)``,
    held to ω ≥ 0 by at most ``maxiter`` redraws, else its ancestor x_i.
    float64."""
    h = math.sqrt(max(1.0 - a * a, 0.0))
    s = h * math.sqrt(float(var) + zero_cov)
    grid = grid.to(torch.float64)
    out = torch.zeros_like(grid)
    for lo in range(0, w.shape[0], _BLOCK):
        wb = w[lo:lo + _BLOCK].to(torch.float64)
        xb = x[lo:lo + _BLOCK, 0].to(torch.float64)
        c = a * xb + (1.0 - a) * float(mu)
        below = _phi(-c / s)               # mass a proposal puts below 0
        p_ok = 1.0 - below
        q = torch.where(p_ok > 0, below ** (maxiter + 1),
                        torch.ones_like(p_ok))
        inside = (_phi((grid[None, :] - c[:, None]) / s)
                  - below[:, None]).clamp_min(0.0)
        trunc = torch.where(p_ok[:, None] > 0,
                            inside / p_ok.clamp_min(1e-300)[:, None], 0.0)
        trunc = torch.where(grid[None, :] >= 0, trunc.clamp_max(1.0), 0.0)
        kept = (xb[:, None] <= grid[None, :]).to(torch.float64)
        out += ((1.0 - q)[:, None] * trunc + q[:, None] * kept).T @ wb
    return out


def resample(generator, w, x, a, maxiter, ar):
    """The control's Liu-West resample (one process)."""
    return liu_west(generator, ar.cast(w), ar.cast(x), a, maxiter, valid,
                    lambda y: y, ar)


def eig_partials(w, omega, times, ar):
    """This rank's partial sums of the expected information gain of each
    time in ``times`` (C,): ``(marginal Pr(0) (C,), Σ w·H(Pr(·|ω)) (C,))``;
    IG = H(marginal) − the second, once both are summed over the ranks."""
    tiny = 1e-30
    p0 = torch.cos(ar.mul(omega[:, None].expand(-1, times.shape[0]),
                          0.5 * times.to(ar.dtype)[None, :]
                          .expand(omega.shape[0], -1))) ** 2
    p1 = 1.0 - p0
    marg0 = ar.mm(ar.cast(w)[None, :], p0)[0]
    h_cond = -(p0 * torch.log(p0.clamp_min(tiny))
               + p1 * torch.log(p1.clamp_min(tiny)))
    return marg0, ar.mm(ar.cast(w)[None, :], h_cond)[0]


def eig_from_partials(marg0, cond):
    tiny = 1e-30
    m1 = 1.0 - marg0
    h = -(marg0 * torch.log(marg0.clamp_min(tiny))
          + m1 * torch.log(m1.clamp_min(tiny)))
    return h - cond
