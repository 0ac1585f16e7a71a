"""Parity of the port's resampling pieces against the JAX package.

Deterministic pieces (counting multiplicities, weighted moments, the PSD
square root) take the same NumPy inputs in both packages. Liu-West draws
from different random streams (a torch.Generator against JAX keys), so
it is held to the same statistical properties as
``tests/test_resamplers.py``, in both packages, over several seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu.resamplers import (
    LiuWestResampler as JaxLiuWest,
    counting_multiplicities_from_u as jax_counting,
)
from qinfer_tpu.utils import (
    sqrtm_psd as jax_sqrtm_psd,
    weighted_moments as jax_moments,
)

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.resamplers import (
    LiuWestResampler,
    counting_locations_from_u,
    counting_multiplicities_from_u,
)
from qinfer_tpu_torch.utils import sqrtm_psd, weighted_moments


def _cloud(seed, n=4000):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2)) @ np.array([[1.0, 0.3], [0.0, 0.5]])
    x = (x + np.array([1.0, -2.0])).astype(np.float32)
    w = np.exp(-0.05 * np.sum(x.astype(np.float64) ** 2, axis=1))
    return (w / w.sum()).astype(np.float32), x


class _FreeTorch(qt.Model):
    """Two unconstrained parameters (every location is valid)."""

    @property
    def n_modelparams(self):
        return 2

    def are_models_valid(self, mps):
        return torch.ones(mps.shape[0], dtype=torch.bool)


class _FreeJax(q.Model):
    def __init__(self):
        super().__init__()

    @property
    def n_modelparams(self):
        return 2

    @property
    def expparams_dtype(self):
        return [("t", "float32")]

    def are_models_valid(self, mps):
        return jnp.ones(jnp.atleast_2d(mps).shape[0], dtype=bool)


@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
@pytest.mark.parametrize("n", [1000, 4096])
def test_counting_multiplicities_match_jax(n, u):
    """Σm = n exactly in both; the offsets agree to within one slot (f32
    cumsum order: XLA's against torch's) and almost everywhere exactly."""
    rng = np.random.default_rng(n)
    w = (rng.pareto(0.6, n) + 1e-12).astype(np.float32)
    w /= w.sum()
    m_j, s_j = (np.asarray(a) for a in jax_counting(u, jnp.asarray(w), n))
    m_t, s_t = counting_multiplicities_from_u(u, torch.from_numpy(w), n)
    m_t, s_t = m_t.numpy(), s_t.numpy()
    assert m_t.dtype == np.int32 and s_t.dtype == np.int32
    assert m_t.sum() == n and m_j.sum() == n
    assert (m_t >= 0).all()
    np.testing.assert_array_equal(s_t, np.cumsum(m_t) - m_t)
    assert np.abs(s_t - s_j).max() <= 1
    assert (s_t != s_j).mean() < 0.01


def test_counting_locations_expand_the_counts():
    rng = np.random.default_rng(2)
    n = 2000
    w = torch.from_numpy(rng.random(n, dtype=np.float32))
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    m, _ = counting_multiplicities_from_u(0.25, w, n)
    got = counting_locations_from_u(0.25, w, x)
    np.testing.assert_array_equal(got.numpy(),
                                  np.repeat(x.numpy(), m.numpy(), axis=0))


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_moments_match_jax(seed):
    w, x = _cloud(seed)
    mu_j, cov_j = jax_moments(jnp.asarray(w), jnp.asarray(x))
    mu_t, cov_t = weighted_moments(torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-5,
                               atol=1e-6)


def test_sqrtm_psd_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    psd = a @ a.T
    indefinite = psd - 2.0 * np.eye(3, dtype=np.float32)
    for A in (psd, indefinite):
        got = sqrtm_psd(torch.from_numpy(A)).numpy()
        want = np.asarray(jax_sqrtm_psd(jnp.asarray(A)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    S = sqrtm_psd(torch.from_numpy(psd)).numpy()
    np.testing.assert_allclose(S @ S, psd, rtol=1e-4, atol=1e-4)


def test_liu_west_cholesky_falls_back_to_sqrtm():
    """An indefinite Σ (negative jitter) makes Cholesky fail; both packages
    fall back to the eigenvalue-clipped square root and stay finite."""
    w, x = _cloud(3, n=500)
    x[:, 1] = 0.25  # zero variance in one coordinate
    lw = LiuWestResampler(a=0.9, zero_cov_comp=-1e-3)
    _, new_x = lw(_FreeTorch(), torch.Generator().manual_seed(0),
                  torch.from_numpy(w), torch.from_numpy(x))
    _, new_x_j = JaxLiuWest(a=0.9, zero_cov_comp=-1e-3)(
        _FreeJax(), jax.random.key(0), jnp.asarray(w), jnp.asarray(x))
    for out in (new_x.numpy(), np.asarray(new_x_j)):
        assert np.isfinite(out).all()
        # the clipped direction gets (almost) no kernel noise
        assert np.abs(out[:, 1] - 0.25).max() < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_liu_west_preserves_moments_like_jax(seed):
    w, x = _cloud(seed)
    mu0, cov0 = (np.asarray(a) for a in jax_moments(jnp.asarray(w),
                                                     jnp.asarray(x)))
    new_w, new_x, nf = LiuWestResampler(a=0.98).call_with_diagnostics(
        _FreeTorch(), torch.Generator().manual_seed(seed),
        torch.from_numpy(w), torch.from_numpy(x))
    jw, jx = JaxLiuWest(a=0.98)(_FreeJax(), jax.random.key(seed),
                                jnp.asarray(w), jnp.asarray(x))
    assert int(nf) == 0
    np.testing.assert_allclose(new_w.numpy(), 1.0 / len(w), atol=1e-8)
    for ww, xx in ((new_w.numpy(), new_x.numpy()),
                   (np.asarray(jw), np.asarray(jx))):
        mu1, cov1 = (np.asarray(a) for a in jax_moments(jnp.asarray(ww),
                                                         jnp.asarray(xx)))
        np.testing.assert_allclose(mu1, mu0, atol=0.1)
        np.testing.assert_allclose(cov1, cov0, rtol=0.25, atol=0.05)


def test_liu_west_bootstrap_is_a_subset_of_the_inputs():
    w, x = _cloud(5, n=500)
    _, new_x = LiuWestResampler(a=1.0, postselect=False)(
        _FreeTorch(), torch.Generator().manual_seed(1),
        torch.from_numpy(w), torch.from_numpy(x))
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in new_x.numpy().tolist())


def test_liu_west_validity_and_fallback_count_like_jax():
    """A cloud hugging the boundary ω = 0 with a wide kernel and a single
    redraw round: some slots stay invalid and keep their ancestors. Both
    packages keep every output valid and count the same fallback rate
    within 6 σ."""
    n = 4000
    rng = np.random.default_rng(9)
    x = (np.abs(rng.normal(size=(n, 1))) * 1e-3).astype(np.float32)
    w = np.full(n, 1.0 / n, np.float32)
    _, new_x, nf = LiuWestResampler(a=0.5, maxiter=1).call_with_diagnostics(
        qt.SimplePrecessionModel(), torch.Generator().manual_seed(0),
        torch.from_numpy(w), torch.from_numpy(x))
    _, new_x_j, nf_j = JaxLiuWest(a=0.5, maxiter=1).call_with_diagnostics(
        q.SimplePrecessionModel(), jax.random.key(0), jnp.asarray(w),
        jnp.asarray(x))
    assert (new_x.numpy() >= 0).all() and (np.asarray(new_x_j) >= 0).all()
    p = int(nf_j) / n
    assert p > 0.002
    assert abs(int(nf) - int(nf_j)) < 6 * np.sqrt(2 * n * p * (1 - p))
