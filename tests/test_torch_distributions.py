"""Parity of the port's distributions against the JAX package.

* Samplers: 2·10⁵ draws from each package; each coordinate's mean and
  variance agree within 4 combined Monte-Carlo errors (the two packages'
  streams never match), and a univariate continuous draw passes a
  Kolmogorov-Smirnov test against its exact CDF at p > 1e-4.
* Densities (``log_pdf``, ``grad_log_pdf``) on the same NumPy points at
  rtol 1e-5 in float32.
* The inverse-CDF grid of ``InterpolatedUnivariateDistribution`` equal to
  JAX's, and its interpolation equal to ``jnp.interp`` at the same
  uniforms (rtol 1e-6); the Bloch coordinates of the qudit priors equal
  to JAX's ``_bloch_coords`` on the same matrices; the GADFLI prior's
  fiducial carried over with ``convert``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import qinfer_tpu as q
import qinfer_tpu.distributions as jd
import qinfer_tpu.tomography as jtomo
import qinfer_tpu_torch as qt
import qinfer_tpu_torch.distributions as td
import qinfer_tpu_torch.tomography as ttomo
from qinfer_tpu_torch import convert

N_DRAWS = 200_000


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _normal_pdf(x):
    return np.exp(-0.5 * x * x)


#: name -> (JAX distribution, port distribution, exact CDF or None)
def _cases(pkg):
    return {
        "uniform": (pkg.UniformDistribution([[0, 1], [-2, 3]]), None),
        "discrete_uniform": (pkg.DiscreteUniformDistribution(3), None),
        "mv_uniform": (pkg.MVUniformDistribution(4), None),
        "constant": (pkg.ConstantDistribution([1.0, -2.0]), None),
        "normal": (pkg.NormalDistribution(1.0, 4.0),
                   st.norm(1.0, 2.0).cdf),
        "truncated_normal": (pkg.NormalDistribution(0.0, 1.0,
                                                    trunc=(-0.5, 1.5)),
                             st.truncnorm(-0.5, 1.5).cdf),
        "mv_normal": (pkg.MultivariateNormalDistribution(
            [0.0, 1.0, -1.0], [[1.0, 0.5, 0.0], [0.5, 2.0, 0.3],
                               [0.0, 0.3, 0.5]]), None),
        "slanted_normal": (pkg.SlantedNormalDistribution([[0, 1], [2, 3]],
                                                         0.1), None),
        "lognormal": (pkg.LogNormalDistribution(0.3, 0.5),
                      st.lognorm(0.5, scale=math.exp(0.3)).cdf),
        "beta": (pkg.BetaDistribution(2.0, 5.0), st.beta(2.0, 5.0).cdf),
        "beta_mean_var": (pkg.BetaDistribution(mean=0.3, var=0.01),
                          st.beta(0.3 * 20, 0.7 * 20).cdf),
        "beta_binomial": (pkg.BetaBinomialDistribution(12, 2.0, 3.0), None),
        "gamma": (pkg.GammaDistribution(0.7, 2.0),
                  st.gamma(0.7, scale=0.5).cdf),
        "gamma_mean_var": (pkg.GammaDistribution(mean=3.0, var=2.0),
                           st.gamma(4.5, scale=2.0 / 3.0).cdf),
        "interpolated": (pkg.InterpolatedUnivariateDistribution(
            _normal_pdf, 2.0, 1500), st.norm().cdf),
        "product": (pkg.ProductDistribution(
            pkg.NormalDistribution(0.0, 1.0),
            pkg.GammaDistribution(2.0, 1.0)), None),
        "mixture": (pkg.MixtureDistribution(
            [0.3, 0.7], [pkg.NormalDistribution(0.0, 1.0),
                         pkg.NormalDistribution(5.0, 1.0)]),
            lambda x: 0.3 * st.norm(0, 1).cdf(x) + 0.7 * st.norm(5, 1).cdf(x)),
        "mixture_from_class": (pkg.MixtureDistribution(
            [0.5, 0.5], pkg.NormalDistribution,
            dist_args=[(0.0, 1.0), (3.0, 0.25)]), None),
        "constrained_sum": (pkg.ConstrainedSumDistribution(
            pkg.UniformDistribution([[0, 1]] * 3), 2.0), None),
        "haar_qubit": (pkg.HaarUniform(2), None),
        "ginibre_qutrit": (pkg.GinibreUniform(3, 2), None),
        "hilbert_schmidt_qubit": (pkg.HilbertSchmidtUniform(2), None),
    }


CASES = list(_cases(qt))


def _moments(x):
    """Per-coordinate mean, variance and their Monte-Carlo errors."""
    x = np.asarray(x, np.float64).reshape(x.shape[0], -1)
    n = x.shape[0]
    mean = x.mean(0)
    xc = x - mean
    var = (xc ** 2).mean(0)
    m4 = (xc ** 4).mean(0)
    return mean, var, np.sqrt(var / n), np.sqrt(np.maximum(m4 - var ** 2,
                                                           0.0) / n)


@pytest.mark.parametrize("name", CASES)
def test_torch_sampler_moments_match_jax(name):
    jdist, _ = _cases(q)[name]
    tdist, cdf = _cases(qt)[name]
    assert tdist.n_rvs == jdist.n_rvs
    want = np.asarray(jdist.sample(jax.random.key(7), N_DRAWS))
    got = tdist.sample(_gen(7), N_DRAWS).numpy()
    assert got.shape == want.shape == (N_DRAWS, jdist.n_rvs)
    assert got.dtype == np.float32
    mj, vj, smj, svj = _moments(want)
    mt, vt, smt, svt = _moments(got)
    assert np.all(np.abs(mt - mj) <= 4 * np.hypot(smt, smj) + 1e-7)
    assert np.all(np.abs(vt - vj) <= 4 * np.hypot(svt, svj) + 1e-7)
    if cdf is not None:
        assert st.kstest(got[:, 0], cdf).pvalue > 1e-4


def test_torch_sampler_supports_and_constraints():
    g = _gen(3)
    simplex = qt.MVUniformDistribution(5).sample(g, 1000)
    assert bool((simplex >= 0).all())
    torch.testing.assert_close(simplex.sum(1), torch.ones(1000))
    cs = qt.ConstrainedSumDistribution(qt.MVUniformDistribution(3), 3.0)
    torch.testing.assert_close(cs.sample(g, 100).sum(1),
                               torch.full((100,), 3.0))
    du = qt.DiscreteUniformDistribution(2).sample(g, 1000)
    assert set(du.unique().tolist()) == {0.0, 1.0, 2.0, 3.0}
    bb = qt.BetaBinomialDistribution(5, 1.0, 1.0).sample(g, 1000)
    assert bb.min() >= 0 and bb.max() <= 5 and bool((bb == bb.round()).all())
    haar = qt.HaarUniform(2).sample(g, 1000)
    torch.testing.assert_close(torch.linalg.vector_norm(haar, dim=1),
                               torch.ones(1000), rtol=0, atol=1e-5)
    mixed = qt.HilbertSchmidtUniform(2).sample(g, 1000)
    assert float(torch.linalg.vector_norm(mixed, dim=1).max()) <= 1 + 1e-5
    assert qt.HaarUniform(3)._sample_one(g).shape == (8,)
    with pytest.raises(ValueError):
        qt.BetaDistribution(alpha=1.0)
    with pytest.raises(ValueError):
        qt.MixtureDistribution([0.5, 0.5], [qt.NormalDistribution(0, 1)])


def _density_cases(pkg):
    return {
        "normal": pkg.NormalDistribution(1.0, 4.0),
        "truncated_normal": pkg.NormalDistribution(0.0, 1.0,
                                                   trunc=(-0.5, 1.5)),
        "mv_normal": pkg.MultivariateNormalDistribution(
            [0.0, 1.0], [[1.0, 0.5], [0.5, 2.0]]),
        "lognormal": pkg.LogNormalDistribution(0.3, 0.5),
        "beta": pkg.BetaDistribution(2.0, 5.0),
        "gamma": pkg.GammaDistribution(0.7, 2.0),
        "product": pkg.ProductDistribution(
            pkg.NormalDistribution(0.0, 1.0),
            pkg.GammaDistribution(2.0, 1.0)),
        "postselected_product": pkg.PostselectedDistribution(
            pkg.ProductDistribution(pkg.UniformDistribution([[0, 1]]),
                                    pkg.BetaDistribution(2.0, 2.0)),
            pkg.CoinModel()),
    }


@pytest.mark.parametrize("name", list(_density_cases(qt)))
def test_torch_log_pdf_matches_jax(name):
    jdist = _density_cases(q)[name]
    tdist = _density_cases(qt)[name]
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-0.8, 2.5, (64, jdist.n_rvs)).astype(np.float32)
    want = np.asarray(jdist.log_pdf(jnp.asarray(x)))
    got = tdist.log_pdf(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    if hasattr(jdist, "grad_log_pdf") and name != "truncated_normal":
        np.testing.assert_allclose(
            tdist.grad_log_pdf(torch.as_tensor(x)).numpy(),
            np.asarray(jdist.grad_log_pdf(jnp.asarray(x))), rtol=1e-5,
            atol=1e-5)


@pytest.mark.parametrize("scale, n_points", [(1.0, 1500), (3.0, 200)])
def test_interpolated_grid_and_interp_match_jax(scale, n_points):
    def pdf(x):
        return np.exp(-np.abs(x - 0.5)) * (1 + np.sin(x) ** 2)

    jdist = q.InterpolatedUnivariateDistribution(pdf, scale, n_points)
    tdist = qt.InterpolatedUnivariateDistribution(pdf, scale, n_points)
    np.testing.assert_array_equal(tdist.xs.numpy(), np.asarray(jdist.xs))
    np.testing.assert_array_equal(tdist.cdf.numpy(), np.asarray(jdist.cdf))
    carried = convert.distribution_from_numpy(
        "InterpolatedUnivariateDistribution",
        {"xs": np.asarray(jdist.xs), "cdf": np.asarray(jdist.cdf)})
    u = np.random.default_rng(1).uniform(0, 1, 5000).astype(np.float32)
    u[:3] = [0.0, 1.0, float(jdist.cdf[1])]
    want = np.asarray(jnp.interp(jnp.asarray(u), jdist.cdf, jdist.xs))
    for d in (tdist, carried):
        got = td._interp(torch.as_tensor(u), d.cdf, d.xs).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_bloch_coords_match_jax(dim):
    rng = np.random.default_rng(dim)
    a = rng.normal(size=(5, dim, dim)) + 1j * rng.normal(size=(5, dim, dim))
    rho = a @ a.conj().transpose(0, 2, 1)
    rho /= np.trace(rho, axis1=1, axis2=2)[:, None, None]
    re, im = rho.real.astype(np.float32), rho.imag.astype(np.float32)
    got = td._bloch_coords(torch.as_tensor(re), torch.as_tensor(im)).numpy()
    want = np.stack([np.asarray(jd._bloch_coords(jnp.asarray(r),
                                                 jnp.asarray(i)))
                     for r, i in zip(re, im)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alpha, beta", [(1.0, 9.0), (5.0, 5.0)])
def test_gadfli_prior_carries_over_and_matches_jax_moments(alpha, beta):
    """The GADFLI prior built from a JAX prior's embedded fiducial: the
    same embedding, and sample means of every coordinate within 4
    combined Monte-Carlo errors of JAX's."""
    jb = jtomo.pauli_basis(2)
    tb = convert.tomography_basis_from_numpy(np.asarray(jb.data), jb.dims,
                                             jb.labels)
    psi = np.array([1, 0, 0, 1], np.complex64) / np.sqrt(2)
    fid = np.outer(psi, psi.conj())
    jp = jtomo.GADFLIDistribution(jb, fid, alpha=alpha, beta=beta)
    tp = convert.distribution_from_numpy(
        "GADFLIDistribution",
        {"fiducial_embedded": np.asarray(jp.fiducial_embedded),
         "alpha": jp.alpha, "beta": jp.beta, "rank": jp.rank}, basis=tb)
    direct = ttomo.GADFLIDistribution(tb, fid, alpha=alpha, beta=beta)
    np.testing.assert_array_equal(tp.fiducial_embedded.numpy(),
                                  np.asarray(jp.fiducial_embedded))
    np.testing.assert_array_equal(direct.fiducial_embedded.numpy(),
                                  np.asarray(jp.fiducial_embedded))
    n = 40_000
    want = np.asarray(jp.sample(jax.random.key(2), n))
    got = tp.sample(_gen(2), n).numpy()
    assert got.shape == want.shape == (n, 15)
    mj, _, smj, _ = _moments(want)
    mt, _, smt, _ = _moments(got)
    assert np.all(np.abs(mt - mj) <= 4 * np.hypot(smt, smj))
    model = ttomo.TomographyModel(tb)
    assert bool(model.are_models_valid(torch.as_tensor(got[:2000])).all())
