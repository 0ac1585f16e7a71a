"""Parity of the port's posterior and region estimators, its resampling
diagnostics and ``SMCUpdaterBCRB`` against the JAX package.

Each estimator reads ONE posterior: a JAX updater conditions a binomial
RB (or Ramsey) record without resampling, and its state is carried into
the port with ``convert.state_from_numpy``, so both packages hold the
same float32 weights and particles. Tolerances:

* the credible set, hull, MVEE and marginal histogram: exact (the same
  float32 weights sort the same way, ties in index order in both; the
  rest is the same float64 host code on the same points);
* ``in_credible_region``: equal, except for ``'est_cov'`` points whose
  quadratic form lies within 1e-3 of the boundary (the covariance is a
  float32 reduction in each library);
* entropy and ``est_meanfn`` to rtol 1e-5, the KL divergence to rtol 1e-4
  and atol 1e-5 nat (float32 sums over n particles of logsumexps over n);
* ``mvee``, ``in_ellipsoid`` and ``ellipsoid_volume`` in float64: equal;
* the BCRB's information matrix to rtol 1e-4 after 12 updates (each a
  float32 sum over n particles of the Fisher information).
"""

import logging
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu.utils import (ellipsoid_volume as jax_ellipsoid_volume,
                              in_ellipsoid as jax_in_ellipsoid,
                              mvee as jax_mvee,
                              particle_meanfn as jax_particle_meanfn)

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.convert import state_from_numpy
from qinfer_tpu_torch.smc import _kl_divergence

N = 3000
RB_RANGES = [[0.8, 1.0], [0.3, 0.7], [0.3, 0.7]]


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if f != "key"}


def _rb_record(n_exp, seed):
    rng = np.random.default_rng(seed)
    ms = np.tile([2, 5, 10, 20, 40, 80, 160], n_exp)[:n_exp]
    counts = rng.binomial(25, np.clip(0.5 * 0.95 ** ms + 0.45, 0, 1))
    return counts.astype(np.int32), {"m": ms.astype(np.float32),
                                     "n_meas": np.full(n_exp, 25, np.int32)}


def _pair(n_exp=6, seed=0):
    """A JAX RB updater conditioned on ``n_exp`` experiments without
    resampling, and a port updater holding the same state."""
    jm = q.BinomialModel(q.RandomizedBenchmarkingModel(), n_meas_max=25)
    ju = q.SMCUpdater(jm, N, q.UniformDistribution(RB_RANGES), seed=seed,
                      resample_thresh=0.0)
    if n_exp:
        counts, eps = _rb_record(n_exp, seed)
        ju.batch_update(jnp.asarray(counts),
                        {k: jnp.asarray(v) for k, v in eps.items()},
                        resample_interval=0)
    tm = qt.BinomialModel(qt.RandomizedBenchmarkingModel(), n_meas_max=25)
    tu = qt.SMCUpdater(tm, N, qt.UniformDistribution(RB_RANGES),
                       device="cpu")
    tu.state = state_from_numpy(_jax_arrays(ju.state), "cpu")
    return ju, tu


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_carried_weights_are_distinct_and_uneven(pair):
    ju, tu = pair
    w = tu.particle_weights
    assert torch.equal(w, torch.as_tensor(np.array(ju.particle_weights)))
    assert float(w.max()) > 20.0 / N
    # mostly distinct; the rest underflowed to 0 and ties there
    assert torch.unique(w).numel() > 0.5 * N
    assert int((w == 0).sum()) > 1


def test_entropy_and_meanfn_match_jax(pair):
    ju, tu = pair
    np.testing.assert_allclose(float(tu.est_entropy()),
                               float(ju.est_entropy()), rtol=1e-5)
    fns = [
        (lambda x: jnp.stack([x[0] ** 2, x[1] * x[2]]),
         lambda x: torch.stack([x[0] ** 2, x[1] * x[2]])),
        (lambda x: (jnp.sum(x), jnp.outer(x, x)),
         lambda x: (torch.sum(x), torch.outer(x, x))),
        (lambda x: {"p": x[0], "AB": x[1] + x[2]},
         lambda x: {"p": x[0], "AB": x[1] + x[2]}),
    ]
    for jfn, tfn in fns:
        want = ju.est_meanfn(jfn)
        got = tu.est_meanfn(tfn)
        if isinstance(want, dict):
            assert set(got) == set(want)
            pairs = [(got[k], want[k]) for k in want]
        elif isinstance(want, tuple):
            assert isinstance(got, tuple)
            pairs = list(zip(got, want))
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # the utility itself, and no fn: the mean
    w = tu.particle_weights
    x = tu.particle_locations
    np.testing.assert_allclose(
        qt.particle_meanfn(w, x, lambda v: v * 2).numpy(),
        np.asarray(jax_particle_meanfn(jnp.asarray(w.numpy()),
                                       jnp.asarray(x.numpy()),
                                       lambda v: v * 2)), rtol=1e-5)
    torch.testing.assert_close(qt.particle_meanfn(w, x), tu.est_mean())


@pytest.mark.parametrize("bandwidth", [None, 0.02])
def test_kl_divergence_matches_jax(pair, bandwidth):
    """D(after 6 experiments ‖ after 3) and D(p ‖ p) = 0."""
    ju, tu = pair
    ju_early, tu_early = _pair(n_exp=3)
    want = float(ju.est_kl_divergence(ju_early, kernel_bandwidth=bandwidth))
    got = float(tu.est_kl_divergence(tu_early, kernel_bandwidth=bandwidth))
    assert want > 0.01
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert abs(float(tu.est_kl_divergence(tu))) < 1e-5


def test_kl_blocks_bound_the_difference_tensor(monkeypatch):
    """Blocks of the points axis give the one-block result."""
    from qinfer_tpu_torch import smc

    g = torch.Generator().manual_seed(3)
    x_p, x_q = torch.rand((500, 3), generator=g), torch.rand((700, 3),
                                                             generator=g)
    w_p = torch.rand(500, generator=g)
    w_q = torch.rand(700, generator=g)
    w_p, w_q = w_p / w_p.sum(), w_q / w_q.sum()
    whole = _kl_divergence(w_p, x_p, w_q, x_q)
    monkeypatch.setattr(smc, "_KDE_BLOCK_ELEMENTS", 7 * 700 * 3)
    torch.testing.assert_close(_kl_divergence(w_p, x_p, w_q, x_q), whole,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("uniform", [False, True])
def test_credible_region_hull_and_mvee_match_jax(uniform):
    """On distinct weights and on all-1/n weights (the state right after a
    resample), where the set is the first k particles in index order."""
    ju, tu = _pair(n_exp=0 if uniform else 6)
    for level in (0.5, 0.95):
        want_in, want_out = ju.est_credible_region(level,
                                                   return_outside=True)
        got_in, got_out = tu.est_credible_region(level, return_outside=True)
        np.testing.assert_array_equal(got_in, want_in)
        np.testing.assert_array_equal(got_out, want_out)
    if uniform:
        k = len(got_in)
        np.testing.assert_array_equal(got_in,
                                      tu.particle_locations[:k].numpy())
    sl = [0, 2]
    np.testing.assert_array_equal(
        tu.est_credible_region(0.9, modelparam_slice=sl),
        ju.est_credible_region(0.9, modelparam_slice=sl))
    got_v, got_hull = tu.region_est_hull(0.95)
    want_v, _ = ju.region_est_hull(0.95)
    np.testing.assert_array_equal(got_v, want_v)
    assert got_hull.volume > 0
    A, c = tu.region_est_ellipsoid(0.95)
    A_j, c_j = ju.region_est_ellipsoid(0.95)
    np.testing.assert_array_equal(A, A_j)
    np.testing.assert_array_equal(c, c_j)
    lo_hi, none = tu.region_est_hull(0.95, modelparam_slice=[1])
    assert none is None and lo_hi.shape == (2, 1)


def test_in_credible_region_matches_jax(pair):
    ju, tu = pair
    rng = np.random.default_rng(11)
    mu = tu.est_mean().numpy()
    sd = np.sqrt(np.diag(tu.est_covariance_mtx().numpy()))
    pts = mu + sd * rng.standard_normal((400, 3)) * 2.0
    for method in ("hpd_hull", "hpd_mvee"):
        got = tu.in_credible_region(pts, 0.9, method=method)
        want = ju.in_credible_region(pts, 0.9, method=method)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(pts)
    got = tu.in_credible_region(pts, 0.9, method="est_cov")
    want = ju.in_credible_region(pts, 0.9, method="est_cov")
    from scipy.stats import chi2

    w = np.asarray(ju.particle_weights, np.float64)
    x = np.asarray(ju.particle_locations, np.float64)
    m = w @ x
    cov = (w[:, None] * (x - m)).T @ (x - m) * chi2.ppf(0.9, df=3)
    form = np.einsum("ni,ij,nj->n", pts - m, np.linalg.inv(cov), pts - m)
    clear = np.abs(form - 1.0) > 1e-3
    np.testing.assert_array_equal(got[clear], want[clear])
    assert 0 < got.sum() < len(pts)
    one_d = tu.in_credible_region(pts[:, :1], 0.9, modelparam_slice=[0])
    np.testing.assert_array_equal(
        one_d, ju.in_credible_region(pts[:, :1], 0.9, modelparam_slice=[0]))
    with pytest.raises(ValueError):
        tu.in_credible_region(pts, method="nope")


def test_posterior_marginal_matches_jax(pair):
    ju, tu = pair
    for kw in ({}, {"res": 40, "smoothing": 1.5},
               {"idx_param": 2, "range_min": 0.3, "range_max": 0.7}):
        gx, gy = tu.posterior_marginal(**kw)
        wx, wy = ju.posterior_marginal(**kw)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_allclose(gy, wy, rtol=1e-12, atol=1e-12)


def test_ellipsoid_helpers_equal_jax_in_float64():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((60, 3)) @ np.diag([1.0, 0.3, 2.0]) + 0.5
    A, c = qt.mvee(pts, tol=1e-6)
    A_j, c_j = jax_mvee(pts, tol=1e-6)
    np.testing.assert_array_equal(A, A_j)
    np.testing.assert_array_equal(c, c_j)
    shape = np.linalg.inv(A)
    probe = rng.standard_normal((200, 3)) * 2
    np.testing.assert_array_equal(qt.in_ellipsoid(probe, shape, c),
                                  jax_in_ellipsoid(probe, shape, c))
    # every point lies in its MVEE, up to Khachiyan's tolerance
    assert qt.in_ellipsoid(pts, shape * (1 + 1e-3), c).all()
    assert qt.ellipsoid_volume(shape) == jax_ellipsoid_volume(shape)
    assert qt.ellipsoid_volume(invA=A) == jax_ellipsoid_volume(invA=A)
    np.testing.assert_allclose(qt.ellipsoid_volume(np.eye(2)), np.pi)
    with pytest.raises(ValueError):
        qt.ellipsoid_volume()


def test_particle_distribution_and_sampling_match_jax(pair):
    ju, tu = pair
    post = tu.posterior_distribution()
    assert isinstance(post, qt.ParticleDistribution)
    jpost = ju.posterior_distribution()
    np.testing.assert_allclose(post.est_mean().numpy(),
                               np.asarray(jpost.est_mean()), rtol=1e-5)
    np.testing.assert_allclose(post.est_covariance_mtx().numpy(),
                               np.asarray(jpost.est_covariance_mtx()),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(post.n_ess), float(jpost.n_ess),
                               rtol=1e-5)
    assert post.n_particles == N and post.n_rvs == 3
    g = torch.Generator().manual_seed(5)
    draws = post.sample(g, 20_000)
    mean = tu.est_mean().numpy()
    sd = np.sqrt(np.diag(tu.est_covariance_mtx().numpy()))
    assert draws.shape == (20_000, 3)
    assert np.all(np.abs(draws.numpy().mean(0) - mean)
                  < 5 * sd / np.sqrt(20_000))
    state = tu.generator.get_state()
    s = tu.sample(20_000)
    assert not torch.equal(state, tu.generator.get_state())
    assert np.all(np.abs(s.numpy().mean(0) - mean)
                  < 5 * sd / np.sqrt(20_000))
    with pytest.raises(ValueError):
        qt.ParticleDistribution(np.zeros((4, 2)), np.ones(3))
    uniform = qt.ParticleDistribution([[1.0], [3.0]])
    assert float(uniform.est_mean()[0]) == 2.0


def test_resampling_divergence_is_tracked_and_logged(caplog):
    """One divergence per resample, Liu-West and waste-free alike, and the
    DEBUG line of ``debug_resampling``."""
    model = qt.BinomialModel(qt.RamseyModel(), n_meas_max=20)
    prior = qt.UniformDistribution([[0.0, 1.0], [0.0, 0.5]])
    rng = np.random.default_rng(4)
    ts = np.linspace(1.0, 30.0, 24).astype(np.float32)
    counts = rng.binomial(20, 0.5 + 0.4 * np.cos(0.7 * ts) * np.exp(-0.08
                                                                   * ts))
    eps = {"t": ts, "n_meas": np.full(24, 20, np.int32)}
    for opts in ({}, {"n_mcmc_moves": 1, "compress_mcmc_record": True,
                      "waste_free_stages": 4,
                      "zero_weight_policy": "reset"}):
        u = qt.SMCUpdater(model, 800, prior, device="cpu",
                          track_resampling_divergence=True,
                          debug_resampling=True, **opts)
        with caplog.at_level(logging.DEBUG, logger="qinfer_tpu_torch.smc"):
            caplog.clear()
            u.batch_update(counts, eps, resample_interval=1)
        assert u.resample_count >= 2
        assert len(u.resampling_divergences) == u.resample_count
        assert all(np.isfinite(u.resampling_divergences))
        lines = [r.message for r in caplog.records
                 if r.message.startswith("resample #")]
        assert len(lines) == u.resample_count
    assert qt.SMCUpdater(model, 8, prior, device="cpu") \
        .resampling_divergences is None
    with pytest.raises(TypeError, match="MeshSharding"):
        qt.SMCUpdater(model, 8, prior, device="cpu", sharding="mesh")


@pytest.mark.parametrize("adaptive", [False, True])
def test_bcrb_matches_jax(adaptive):
    """Twelve single-shot Ramsey updates from one carried ensemble, with
    no resampling: the accumulated information matrix and its pinv."""
    ju = q.SMCUpdaterBCRB(q.RamseyModel(), N,
                          q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                          adaptive=adaptive, seed=5, resample_thresh=0.0)
    tu = qt.SMCUpdaterBCRB(qt.RamseyModel(), N,
                           qt.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                           adaptive=adaptive, device="cpu",
                           resample_thresh=0.0)
    np.testing.assert_array_equal(tu.current_bim, np.zeros((2, 2)))
    np.testing.assert_array_equal(np.asarray(ju.current_bim),
                                  np.zeros((2, 2)))
    tu.state = state_from_numpy(_jax_arrays(ju.state), "cpu")
    tu._initial_weights = tu.state.weights
    tu._initial_locations = tu.state.locations
    rng = np.random.default_rng(8)
    for k in range(12):
        t = np.float32(1.5 * 1.25 ** k)
        o = int(rng.integers(0, 2))
        ju.update(o, {"t": jnp.asarray([t, 99.0], jnp.float32)})
        tu.update(o, {"t": torch.tensor([t, 99.0])})
    np.testing.assert_allclose(tu.current_bim, np.asarray(ju.current_bim),
                               rtol=1e-4)
    np.testing.assert_allclose(tu.current_bcrb, np.asarray(ju.current_bcrb),
                               rtol=1e-3)
    assert tu.current_bim.dtype == np.float64
    np.testing.assert_allclose(tu.particle_weights.numpy(),
                               np.asarray(ju.particle_weights), rtol=1e-4,
                               atol=1e-9)
    with pytest.raises(ValueError):
        qt.SMCUpdaterBCRB(qt.BinomialModel(qt.RamseyModel()), 8,
                          qt.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                          device="cpu")


def test_bcrb_prior_term_and_initial_bim():
    class Sloped(qt.UniformDistribution):
        def grad_log_pdf(self, x):
            return torch.ones_like(x) * torch.tensor([1.0, 2.0])

    u = qt.SMCUpdaterBCRB(qt.RamseyModel(), 100,
                          Sloped([[0.0, 1.0], [0.0, 0.5]]), device="cpu")
    np.testing.assert_allclose(u.current_bim, [[1.0, 2.0], [2.0, 4.0]],
                               rtol=1e-6)
    u = qt.SMCUpdaterBCRB(qt.RamseyModel(), 100,
                          Sloped([[0.0, 1.0], [0.0, 0.5]]), device="cpu",
                          initial_bim=np.eye(2))
    np.testing.assert_array_equal(u.current_bim, np.eye(2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(u.current_bcrb, np.eye(2))
