"""Prior and sampling distributions (counterpart of
:mod:`qinfer_tpu.distributions`, ``qinfer_tpu/distributions.py:55-788``):
the uniform, normal, beta and gamma families, the inverse-CDF
``InterpolatedUnivariateDistribution``, the combinators (product,
mixture, postselected, constrained sum), ``ParticleDistribution`` and the
Haar, Ginibre and Hilbert-Schmidt qubit priors.

Sampling takes an explicit :class:`torch.Generator`; samples land on the
generator's device. ``torch.distributions``' Beta, Gamma and Dirichlet
ignore any generator, so the draws here call the generator-taking
primitives ``torch._standard_gamma`` and ``torch._sample_dirichlet``
(Beta is two Gammas; Poisson draws are ``torch.poisson``). A prior that
rejuvenation moves may target says so with a ``log_pdf`` or with
``is_flat_on_support`` (:func:`qinfer_tpu_torch.rejuvenation.
resolve_prior_log_pdf`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import EPS
from .utils import particle_covariance_mtx

__all__ = [
    "Distribution",
    "SingleSampleMixin",
    "UniformDistribution",
    "DiscreteUniformDistribution",
    "MVUniformDistribution",
    "ConstantDistribution",
    "NormalDistribution",
    "MultivariateNormalDistribution",
    "SlantedNormalDistribution",
    "LogNormalDistribution",
    "BetaDistribution",
    "BetaBinomialDistribution",
    "GammaDistribution",
    "InterpolatedUnivariateDistribution",
    "ProductDistribution",
    "MixtureDistribution",
    "PostselectedDistribution",
    "ConstrainedSumDistribution",
    "ParticleDistribution",
    "HaarUniform",
    "GinibreUniform",
    "HilbertSchmidtUniform",
    "sample_gamma",
    "sample_beta",
]


def _rows(x):
    """``x`` as a tensor with at least two dimensions."""
    x = torch.as_tensor(x)
    while x.ndim < 2:
        x = x.unsqueeze(0)
    return x


def _normal(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


def _uniform(generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device)


def sample_gamma(generator, alpha, shape):
    """Standard Gamma(alpha) variates of ``shape`` (float32) drawn from
    ``generator`` on its device: ``torch._standard_gamma``, the sampler
    behind ``torch.distributions.Gamma``, called with the generator."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=generator.device)
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=generator)


def sample_beta(generator, alpha, beta, shape):
    """Beta(alpha, beta) variates of ``shape``: X / (X + Y) with X, Y
    independent standard Gammas drawn from ``generator``."""
    x = sample_gamma(generator, alpha, shape)
    y = sample_gamma(generator, beta, shape)
    return x / torch.clamp_min(x + y, EPS)


class _DeviceCache:
    """Copies of a distribution's constant tensors, one per (device,
    dtype): a sampler called every step makes no host→device copy after
    its first call."""

    def _on(self, name, device, dtype=torch.float32):
        cache = self.__dict__.setdefault("_device_cache", {})
        key = (name, torch.device(device), dtype)
        if key not in cache:
            cache[key] = getattr(self, name).to(device=device, dtype=dtype)
        return cache[key]


class Distribution:
    """A distribution over ``n_rvs`` real random variables:
    ``sample(generator, n) -> (n, n_rvs)``."""

    @property
    def n_rvs(self):
        raise NotImplementedError

    def sample(self, generator, n=1):
        raise NotImplementedError


class SingleSampleMixin:
    """Batched ``sample`` in terms of ``_sample_one(generator)`` -> (n_rvs,),
    one draw at a time on the host loop, as QInfer's reference does (the
    JAX package vmaps it over keys). The port's own single-sample priors
    override ``sample`` with a batched draw."""

    def _sample_one(self, generator):
        raise NotImplementedError

    def sample(self, generator, n=1):
        return torch.stack([self._sample_one(generator) for _ in range(n)])


class UniformDistribution(Distribution):
    """Uniform over an axis-aligned box given as ``[[lo, hi], ...]`` (or a
    single ``[lo, hi]`` pair for one variable)."""

    def __init__(self, ranges):
        ranges = torch.as_tensor(ranges, dtype=torch.float32)
        while ranges.ndim < 2:
            ranges = ranges.unsqueeze(0)
        if ranges.ndim != 2 or ranges.shape[-1] != 2:
            raise ValueError("ranges must be of shape (n_rvs, 2)")
        self.ranges = ranges
        self._ranges_on = {}

    @property
    def n_rvs(self):
        return self.ranges.shape[0]

    def sample(self, generator, n=1):
        ranges = self.ranges.to(generator.device)
        lo = ranges[:, 0]
        hi = ranges[:, 1]
        u = torch.rand((n, self.n_rvs), generator=generator,
                       device=generator.device)
        return lo + u * (hi - lo)

    def grad_log_pdf(self, x):
        """∇ log p: zero inside the box (the BCRB's prior term)."""
        return torch.zeros_like(torch.as_tensor(x))

    is_flat_on_support = True

    def log_pdf(self, x):
        """(n,) log-density: −log of the box's volume inside, −inf
        outside."""
        x = torch.as_tensor(x)
        while x.ndim < 2:
            x = x.unsqueeze(0)
        key = (x.device, x.dtype)
        if key not in self._ranges_on:
            # one copy to a device, not one each move sweep
            self._ranges_on[key] = self.ranges.to(device=x.device,
                                                  dtype=x.dtype)
        ranges = self._ranges_on[key]
        lo, hi = ranges[:, 0], ranges[:, 1]
        inside = torch.all((x >= lo) & (x <= hi), dim=-1)
        log_vol = torch.sum(torch.log(hi - lo))
        return torch.where(inside, -log_vol, -torch.inf)


class DiscreteUniformDistribution(Distribution):
    """Uniform over the integers ``0 .. 2**num_bits − 1`` (as float32)."""

    def __init__(self, num_bits):
        self.num_bits = int(num_bits)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        return torch.randint(0, 2 ** self.num_bits, (n, 1),
                             generator=generator,
                             device=generator.device).to(torch.float32)


class MVUniformDistribution(Distribution):
    """Uniform over the probability simplex of ``dim`` components:
    Dirichlet(1, ..., 1) by ``torch._sample_dirichlet`` on the
    generator."""

    def __init__(self, dim=6):
        self.dim = int(dim)

    @property
    def n_rvs(self):
        return self.dim

    def sample(self, generator, n=1):
        ones = torch.ones((n, self.dim), device=generator.device)
        return torch._sample_dirichlet(ones, generator=generator)


class ConstantDistribution(Distribution):
    """A point mass at a fixed vector."""

    def __init__(self, values):
        self.values = torch.atleast_1d(torch.as_tensor(values,
                                                       dtype=torch.float32))

    @property
    def n_rvs(self):
        return self.values.shape[0]

    def sample(self, generator, n=1):
        return self.values.to(generator.device).expand(n, self.n_rvs)


class NormalDistribution(Distribution):
    """Scalar normal with the given mean and VARIANCE, optionally truncated
    to ``trunc = (lo, hi)`` (drawn by inverse CDF between the bounds'
    probabilities)."""

    def __init__(self, mean, var, trunc=None):
        self.mean = float(mean)
        self.var = float(var)
        self.trunc = trunc

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        std = math.sqrt(self.var)
        if self.trunc is None:
            return self.mean + std * _normal(generator, (n, 1))
        lo, hi = self.trunc
        cdf = [0.5 * math.erfc(-((b - self.mean) / std) / math.sqrt(2.0))
               for b in (lo, hi)]
        u = cdf[0] + (cdf[1] - cdf[0]) * _uniform(generator, (n, 1))
        z = math.sqrt(2.0) * torch.erfinv(torch.clamp(2.0 * u - 1.0,
                                                      -1.0 + 1e-7,
                                                      1.0 - 1e-7))
        return torch.clamp(self.mean + std * z, lo, hi)

    def grad_log_pdf(self, x):
        return -(torch.as_tensor(x) - self.mean) / self.var

    def log_pdf(self, x):
        x = _rows(x)[:, 0]
        lp = (-0.5 * (x - self.mean) ** 2 / self.var
              - 0.5 * math.log(2 * math.pi * self.var))
        if self.trunc is not None:
            lo, hi = self.trunc
            lp = torch.where((x >= lo) & (x <= hi), lp, -torch.inf)
        return lp


class MultivariateNormalDistribution(_DeviceCache, Distribution):
    """Multivariate normal with a mean vector and a covariance matrix. A
    draw is ``mean + z @ Fᵀ`` with F = V √Λ from the covariance's
    eigendecomposition (host float64, once), the JAX package's
    ``method="eigh"``; a PSD covariance of any rank works."""

    def __init__(self, mean, cov):
        self.mean = torch.atleast_1d(torch.as_tensor(mean,
                                                     dtype=torch.float32))
        self.cov = torch.atleast_2d(torch.as_tensor(cov, dtype=torch.float32))
        ev, V = np.linalg.eigh(self.cov.double().numpy())
        self.factor = torch.as_tensor(
            V * np.sqrt(np.clip(ev, 0.0, None))[None, :], dtype=torch.float32)

    @property
    def n_rvs(self):
        return self.mean.shape[0]

    def sample(self, generator, n=1):
        dev = generator.device
        z = _normal(generator, (n, self.n_rvs))
        return self._on("mean", dev)[None, :] + z @ self._on("factor", dev).T

    def grad_log_pdf(self, x):
        x = torch.as_tensor(x)
        d = x - self._on("mean", x.device, x.dtype)
        cov = self._on("cov", x.device, x.dtype)
        return -torch.linalg.solve(cov, d.unsqueeze(-1)).squeeze(-1)

    def log_pdf(self, x):
        x = _rows(x)
        d = x - self._on("mean", x.device, x.dtype)
        chol = torch.linalg.cholesky(self._on("cov", x.device, x.dtype))
        z = torch.linalg.solve_triangular(chol, d.T, upper=False)
        log_det = torch.sum(torch.log(torch.diagonal(chol)))
        return (-0.5 * torch.sum(z * z, dim=0) - log_det
                - 0.5 * self.n_rvs * math.log(2 * math.pi))


class SlantedNormalDistribution(_DeviceCache, Distribution):
    """A uniform draw over the box ``ranges`` plus an independent zero-mean
    normal of standard deviation ``weight``."""

    def __init__(self, ranges=((0.0, 1.0),), weight=0.01):
        self.ranges = torch.atleast_2d(torch.as_tensor(ranges,
                                                       dtype=torch.float32))
        self.weight = float(weight)

    @property
    def n_rvs(self):
        return self.ranges.shape[0]

    def sample(self, generator, n=1):
        r = self._on("ranges", generator.device)
        lo, hi = r[:, 0], r[:, 1]
        u = lo + _uniform(generator, (n, self.n_rvs)) * (hi - lo)
        return u + _normal(generator, (n, self.n_rvs)) * self.weight


class LogNormalDistribution(Distribution):
    """exp(N(mu, sigma²))."""

    def __init__(self, mu=0.0, sigma=1.0):
        self.mu = float(mu)
        self.sigma = float(sigma)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        return torch.exp(self.mu + self.sigma * _normal(generator, (n, 1)))

    def log_pdf(self, x):
        x = _rows(x)[:, 0]
        safe = torch.clamp_min(x, EPS)
        lp = (-0.5 * ((torch.log(safe) - self.mu) / self.sigma) ** 2
              - torch.log(safe * self.sigma) - 0.5 * math.log(2 * math.pi))
        return torch.where(x > 0, lp, -torch.inf)


def _beta_params(alpha, beta, mean, var):
    """(alpha, beta) as given, or by moment matching from (mean, var)."""
    if alpha is not None and beta is not None:
        return float(alpha), float(beta)
    if mean is not None and var is not None:
        mean = float(mean)
        var = float(var)
        nu = mean * (1 - mean) / var - 1.0
        return mean * nu, (1 - mean) * nu
    raise ValueError("specify either (alpha, beta) or (mean, var)")


class BetaDistribution(Distribution):
    """Beta distribution, by (alpha, beta) or by (mean, var)."""

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        self.alpha, self.beta = _beta_params(alpha, beta, mean, var)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        return sample_beta(generator, self.alpha, self.beta, (n, 1))

    def log_pdf(self, x):
        """log density, −inf outside [0, 1] (``scipy.stats.beta.logpdf``)."""
        x = _rows(x)[:, 0]
        log_b = (math.lgamma(self.alpha) + math.lgamma(self.beta)
                 - math.lgamma(self.alpha + self.beta))
        lp = (torch.xlogy(torch.as_tensor(self.alpha - 1.0), x)
              + torch.xlogy(torch.as_tensor(self.beta - 1.0), 1.0 - x)
              - log_b)
        return torch.where((x < 0) | (x > 1), -torch.inf, lp)


class BetaBinomialDistribution(Distribution):
    """Beta-binomial counts out of ``n`` trials (as float32): p from a Beta
    parameterized as :class:`BetaDistribution`, then ``n`` Bernoulli
    trials on uniforms."""

    def __init__(self, n, alpha=None, beta=None, mean=None, var=None):
        self.n = int(n)
        self.alpha, self.beta = _beta_params(alpha, beta, mean, var)

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        p = sample_beta(generator, self.alpha, self.beta, (n, 1))
        u = _uniform(generator, (n, 1, self.n))
        return torch.sum(u < p[..., None], dim=-1).to(torch.float32)


class GammaDistribution(Distribution):
    """Gamma distribution, by (alpha, beta = rate) or by (mean, var)."""

    def __init__(self, alpha=None, beta=None, mean=None, var=None):
        if alpha is not None and beta is not None:
            self.alpha, self.beta = float(alpha), float(beta)
        elif mean is not None and var is not None:
            self.alpha = float(mean) ** 2 / float(var)
            self.beta = float(mean) / float(var)
        else:
            raise ValueError("specify either (alpha, beta) or (mean, var)")

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        return sample_gamma(generator, self.alpha, (n, 1)) / self.beta

    def log_pdf(self, x):
        """log density, −inf below 0 (``scipy.stats.gamma.logpdf`` at
        scale 1/beta)."""
        x = _rows(x)[:, 0]
        y = x * self.beta
        lp = (torch.xlogy(torch.as_tensor(self.alpha - 1.0), y) - y
              - math.lgamma(self.alpha) + math.log(self.beta))
        return torch.where(x < 0, -torch.inf, lp)


def _interp(u, cdf, xs):
    """Piecewise-linear interpolation of ``xs`` over the increasing grid
    ``cdf`` at ``u``, ``jnp.interp``'s arithmetic (a flat segment takes
    its left end; outside the grid the end values)."""
    i = torch.clamp(torch.searchsorted(cdf, u, right=True), 1,
                    cdf.shape[0] - 1)
    c0, c1 = cdf[i - 1], cdf[i]
    x0, x1 = xs[i - 1], xs[i]
    dc = c1 - c0
    flat = torch.abs(dc) <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(flat, x0, x0 + ((u - c0) / torch.where(flat, 1.0, dc))
                    * (x1 - x0))
    f = torch.where(u < cdf[0], xs[0], f)
    return torch.where(u > cdf[-1], xs[-1], f)


class InterpolatedUnivariateDistribution(_DeviceCache, Distribution):
    """A distribution given by an unnormalized pdf callable, sampled by
    inverse CDF: the CDF is built once on the host (trapezoids in float64
    over ``n_interp_points`` points of the compactified line x = scale ·
    arctanh(u)) and a draw interpolates it at a uniform
    (``torch.searchsorted`` plus linear interpolation; torch has no
    ``interp``). :meth:`from_grid` takes a grid built elsewhere."""

    def __init__(self, pdf, compactification_scale=1.0, n_interp_points=1500):
        self.compactification_scale = float(compactification_scale)
        self.n_interp_points = int(n_interp_points)
        u = np.linspace(-1.0, 1.0, n_interp_points + 2)[1:-1]
        xs = self.compactification_scale * np.arctanh(u)
        ps = np.clip(np.asarray(pdf(xs), dtype=np.float64), 0.0, None)
        cdf = np.concatenate([[0.0], np.cumsum((ps[1:] + ps[:-1])
                                               * np.diff(xs) / 2.0)])
        cdf /= cdf[-1]
        self.xs = torch.as_tensor(xs, dtype=torch.float32)
        self.cdf = torch.as_tensor(cdf, dtype=torch.float32)

    @classmethod
    def from_grid(cls, xs, cdf):
        """The distribution of a precomputed grid: points ``xs`` and their
        increasing CDF values ``cdf`` (e.g. a JAX distribution's ``xs``
        and ``cdf`` as NumPy arrays)."""
        self = cls.__new__(cls)
        self.xs = torch.as_tensor(np.asarray(xs), dtype=torch.float32)
        self.cdf = torch.as_tensor(np.asarray(cdf), dtype=torch.float32)
        self.n_interp_points = int(self.xs.shape[0])
        self.compactification_scale = None
        return self

    @property
    def n_rvs(self):
        return 1

    def sample(self, generator, n=1):
        u = _uniform(generator, (n,))
        dev = generator.device
        return _interp(u, self._on("cdf", dev), self._on("xs", dev))[:, None]


# -- combinators --------------------------------------------------------------

class ProductDistribution(Distribution):
    """Independent factors side by side: ``ProductDistribution(a, b)`` or
    ``ProductDistribution([a, b])``; each factor draws from the generator
    in turn."""

    def __init__(self, *factors):
        if len(factors) == 1 and isinstance(factors[0], (list, tuple)):
            factors = tuple(factors[0])
        self.factors = list(factors)

    @property
    def n_rvs(self):
        return sum(f.n_rvs for f in self.factors)

    def sample(self, generator, n=1):
        return torch.cat([f.sample(generator, n) for f in self.factors],
                         dim=1)

    def log_pdf(self, x):
        """The sum of the factors' log-densities over their columns (every
        factor must have ``log_pdf``)."""
        x = _rows(x)
        lp = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        off = 0
        for f in self.factors:
            lp = lp + f.log_pdf(x[:, off:off + f.n_rvs])
            off += f.n_rvs
        return lp


class MixtureDistribution(Distribution):
    """A finite mixture: component instances, or one distribution class
    and per-component constructor arguments (``dist_args``,
    ``dist_kw_args``). A draw picks a component by its weight and takes
    that component's draw (every component draws ``n``, a fixed-shape
    selection; components are few). ``shuffle`` is accepted for the
    reference's signature and does nothing: components are already
    picked per row."""

    def __init__(self, weights, dist, dist_args=None, dist_kw_args=None,
                 shuffle=True):
        del shuffle
        self.weights = torch.as_tensor(weights, dtype=torch.float32)
        if isinstance(dist, (list, tuple)):
            self.components = list(dist)
        else:
            n_comp = self.weights.shape[0]
            args = dist_args if dist_args is not None else [()] * n_comp
            kwargs = (dist_kw_args if dist_kw_args is not None
                      else [{}] * n_comp)
            self.components = [
                dist(**{**args[i], **kwargs[i]}) if isinstance(args[i], dict)
                else dist(*np.atleast_1d(args[i]), **kwargs[i])
                for i in range(n_comp)]
        if len(self.components) != self.weights.shape[0]:
            raise ValueError("len(weights) must match number of components")

    @property
    def n_rvs(self):
        return self.components[0].n_rvs

    @property
    def n_dist(self):
        return len(self.components)

    def sample(self, generator, n=1):
        w = torch.clamp_min(self.weights, EPS).to(generator.device)
        choice = torch.multinomial(w, n, replacement=True,
                                   generator=generator)
        draws = torch.stack([c.sample(generator, n)
                             for c in self.components])  # (n_comp, n, d)
        return draws[choice, torch.arange(n, device=generator.device)]


class PostselectedDistribution(Distribution):
    """A base distribution postselected on a model's validity constraint:
    draws that ``model.are_models_valid`` rejects are redrawn, in masked
    rounds of ``n`` fresh draws on the generator, until every slot is valid
    (the common case pays one round and one sync). ``sample`` raises
    :class:`RuntimeError` when slots are still invalid after ``maxiters``
    rounds, instead of seeding an ensemble with invalid particles."""

    def __init__(self, distribution, model, maxiters=100):
        self.distribution = distribution
        self.model = model
        self.maxiters = int(maxiters)

    @property
    def n_rvs(self):
        return self.distribution.n_rvs

    def log_pdf(self, x):
        """The base log-density inside the validity region, −inf outside;
        unnormalized (the acceptance mass is a constant that cancels in
        Metropolis ratios and in gradients)."""
        x = torch.as_tensor(x)
        while x.ndim < 2:
            x = x.unsqueeze(0)
        lp = self.distribution.log_pdf(x)
        return torch.where(self.model.are_models_valid(x), lp, -torch.inf)

    def sample(self, generator, n=1):
        samples = self.distribution.sample(generator, n)
        valid = self.model.are_models_valid(samples)
        it = 0
        while it < self.maxiters and not bool(valid.all()):
            fresh = self.distribution.sample(generator, n)
            fresh_valid = self.model.are_models_valid(fresh)
            take = ~valid & fresh_valid
            samples = torch.where(take[:, None], fresh, samples)
            valid = valid | fresh_valid
            it += 1
        n_bad = int(torch.sum(~valid))
        if n_bad:
            raise RuntimeError(
                f"PostselectedDistribution: {n_bad}/{n} samples still "
                f"invalid after {self.maxiters} rejection rounds; the "
                "model's validity region has very low acceptance under the "
                "base distribution: raise maxiters or fix the base "
                "distribution's support")
        return samples


class ConstrainedSumDistribution(Distribution):
    """An underlying distribution's draws rescaled so that each row sums
    to ``desired_total`` (a zero row is left as it is)."""

    def __init__(self, underlying_distribution, desired_total=1.0):
        self.underlying_distribution = underlying_distribution
        self.desired_total = float(desired_total)

    @property
    def n_rvs(self):
        return self.underlying_distribution.n_rvs

    def sample(self, generator, n=1):
        s = self.underlying_distribution.sample(generator, n)
        total = torch.sum(s, dim=1, keepdim=True)
        return self.desired_total * s / torch.where(total == 0, 1.0, total)


class ParticleDistribution(Distribution):
    """A weighted particle cloud as a distribution (an SMC posterior handed
    to a fresh updater). Arguments are ``(locations, weights)``; the
    weights default to uniform and are normalized. Draws land on the
    generator's device."""

    def __init__(self, particle_locations, particle_weights=None):
        particle_locations = torch.as_tensor(particle_locations,
                                             dtype=torch.float32)
        while particle_locations.ndim < 2:
            particle_locations = particle_locations.unsqueeze(0)
        n = particle_locations.shape[0]
        if particle_weights is None:
            particle_weights = torch.full((n,), 1.0 / n, dtype=torch.float32,
                                          device=particle_locations.device)
        particle_weights = torch.as_tensor(
            particle_weights, dtype=torch.float32,
            device=particle_locations.device)
        if particle_weights.ndim != 1 or particle_weights.shape[0] != n:
            raise ValueError(
                f"particle_weights must be 1-D with one weight per "
                f"particle; got weights {tuple(particle_weights.shape)} vs "
                f"locations {tuple(particle_locations.shape)} (the argument "
                f"order is (locations, weights))")
        self.particle_locations = particle_locations
        self.particle_weights = particle_weights / torch.sum(particle_weights)

    @property
    def n_rvs(self):
        return self.particle_locations.shape[1]

    @property
    def n_particles(self):
        return self.particle_locations.shape[0]

    @property
    def n_ess(self):
        return 1.0 / torch.sum(self.particle_weights ** 2)

    def est_mean(self):
        return self.particle_weights @ self.particle_locations

    def est_covariance_mtx(self):
        return particle_covariance_mtx(self.particle_weights,
                                       self.particle_locations)

    def sample(self, generator, n=1):
        w = torch.clamp_min(self.particle_weights, EPS).to(generator.device)
        idx = torch.multinomial(w, n, replacement=True, generator=generator)
        return self.particle_locations.to(generator.device)[idx]


# -- qubit and qudit state priors as generalized Bloch vectors ----------------

class HaarUniform(SingleSampleMixin, Distribution):
    """Haar-uniform pure states of dimension ``dim`` as generalized
    (Gell-Mann) Bloch coordinates Tr(ρ λᵢ); for a qubit (x, y, z). A
    normalized complex normal vector a + ib is Haar-distributed; ρ's real
    and imaginary parts are formed from a and b directly."""

    def __init__(self, dim=2):
        self.dim = int(dim)

    @property
    def n_rvs(self):
        return self.dim ** 2 - 1

    def _sample_one(self, generator):
        return self.sample(generator, 1)[0]

    def sample(self, generator, n=1):
        a = _normal(generator, (n, self.dim))
        b = _normal(generator, (n, self.dim))
        nrm = torch.sqrt(torch.sum(a * a + b * b, dim=1, keepdim=True))
        a, b = a / nrm, b / nrm
        re = a[:, :, None] * a[:, None, :] + b[:, :, None] * b[:, None, :]
        im = b[:, :, None] * a[:, None, :] - a[:, :, None] * b[:, None, :]
        return _bloch_coords(re, im)


class GinibreUniform(SingleSampleMixin, Distribution):
    """Ginibre rank-``k`` mixed states of dimension ``dim`` as generalized
    (Gell-Mann) Bloch coordinates."""

    def __init__(self, dim=2, k=2):
        self.dim = int(dim)
        self.k = int(k)

    @property
    def n_rvs(self):
        return self.dim ** 2 - 1

    def _sample_one(self, generator):
        return self.sample(generator, 1)[0]

    def sample(self, generator, n=1):
        return _ginibre_bloch(generator, self.dim, self.k, n)


class HilbertSchmidtUniform(SingleSampleMixin, Distribution):
    """Hilbert-Schmidt-uniform mixed states (Ginibre at k = dim) as
    generalized (Gell-Mann) Bloch coordinates."""

    def __init__(self, dim=2):
        self.dim = int(dim)

    @property
    def n_rvs(self):
        return self.dim ** 2 - 1

    def _sample_one(self, generator):
        return self.sample(generator, 1)[0]

    def sample(self, generator, n=1):
        return _ginibre_bloch(generator, self.dim, self.dim, n)


def _ginibre_bloch(generator, dim, rank, n):
    """Generalized Bloch vectors (n, dim² − 1) of ``n`` Ginibre states
    ρ ∝ GG†, G = A + iB drawn as two real normal (dim, rank) matrices:
    Re GG† = AAᵀ + BBᵀ, Im GG† = BAᵀ − ABᵀ."""
    A = _normal(generator, (n, dim, rank))
    B = _normal(generator, (n, dim, rank))
    At, Bt = A.transpose(1, 2), B.transpose(1, 2)
    re = A @ At + B @ Bt
    im = B @ At - A @ Bt
    tr = torch.diagonal(re, dim1=1, dim2=2).sum(-1)[:, None, None]
    return _bloch_coords(re / tr, im / tr)


def _bloch_coords(re, im):
    """Coordinates Tr(ρ λᵢ) of ρ = re + i·im (..., d, d) in the Gell-Mann
    basis, ordered as ``qinfer_tpu.tomography.bases.gell_mann_basis``:
    the symmetric pairs (2 re[j, k]), the antisymmetric pairs
    (2 im[k, j]), then the d − 1 diagonal generators; for d = 2 exactly
    (x, y, z)."""
    dim = re.shape[-1]
    pairs = [(j, k) for j in range(dim) for k in range(j + 1, dim)]
    out = [2.0 * re[..., j, k] for j, k in pairs]
    out += [2.0 * im[..., k, j] for j, k in pairs]
    diag = torch.diagonal(re, dim1=-2, dim2=-1)
    for l in range(1, dim):
        scale = math.sqrt(2.0 / (l * (l + 1)))
        out.append(scale * (torch.sum(diag[..., :l], dim=-1)
                            - l * diag[..., l]))
    return torch.stack(out, dim=-1)
