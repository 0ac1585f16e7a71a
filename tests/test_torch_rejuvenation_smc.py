"""The port's ``SMCUpdater`` resample-move options against the JAX
package's updater.

* Deterministic: the compressed record after the same committed updates
  (pool rows, int32 totals, padding: equal); the options' validation
  (the same error type and message); which default resampler projects
  (the tolerant-resampler rule); the initial adaptive scale.
* Statistical: the sequential update path with each kind of move lands on
  the conjugate Beta(71, 31) posterior of 70 successes in 100 coin flips
  (mean within 0.02, standard deviation within 0.015: the JAX package's
  ``tests/test_rejuvenation.py`` bars).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats as st
import torch

import qinfer_tpu as q

import qinfer_tpu_torch as qt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pool_sequence(kind):
    """(JAX model, port model, prior pair, [(outcome, eps as NumPy)]): 30
    updates over 11 distinct experiments."""
    rng = np.random.default_rng(1)
    if kind == "binomial":
        jm = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=20)
        tm = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=20)
        ts = np.linspace(0.3, 5.0, 11).astype(np.float32)
        seq = []
        for k in range(30):
            m = int(rng.integers(1, 21))
            seq.append((int(rng.integers(0, m + 1)),
                        {"t": ts[k % 11:k % 11 + 1],
                         "n_meas": np.asarray([m], np.int32)}))
    else:
        jm, tm = q.CoinModel(), qt.CoinModel()
        seq = [(int(rng.integers(0, 2)),
                {"exp_num": np.asarray([k % 11], np.int32)})
               for k in range(30)]
    return jm, tm, seq


@pytest.mark.parametrize("kind", ["binomial", "bernoulli"])
def test_pool_arrays_match_jax(kind):
    jm, tm, seq = _pool_sequence(kind)
    kw = dict(n_mcmc_moves=2, compress_mcmc_record=True,
              resample_thresh=0.0, zero_weight_policy="reset")
    ju = q.SMCUpdater(jm, 64, q.UniformDistribution([[0.0, 1.0]]), **kw)
    tu = qt.SMCUpdater(tm, 64, qt.UniformDistribution([[0.0, 1.0]]),
                       device="cpu", **kw)
    for outcome, eps in seq:
        ju.update(outcome, {k: jnp.asarray(v) for k, v in eps.items()})
        tu.update(outcome, {k: torch.tensor(v) for k, v in eps.items()})
    jeps, jsucc, jtrials = ju._pool_arrays()
    teps, tsucc, ttrials = tu._pool_arrays()
    assert set(teps) == set(jeps)
    for k in jeps:
        assert teps[k].dtype == torch.float32 or teps[k].dtype == torch.int32
        np.testing.assert_array_equal(teps[k].numpy(), np.asarray(jeps[k]))
    for got, want in ((tsucc, jsucc), (ttrials, jtrials)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tsucc.shape[0] == 16 and len(tu._pool_eps) == 11
    assert tu._n_record == ju._n_record == 30
    np.testing.assert_array_equal(ttrials.numpy()[11:], 0)


def test_pool_arrays_refuse_overflowing_totals():
    tu = qt.SMCUpdater(qt.CoinModel(), 64, qt.UniformDistribution([0, 1]),
                       n_mcmc_moves=2, compress_mcmc_record=True,
                       device="cpu")
    tu.update(0, {"exp_num": torch.tensor([0], dtype=torch.int32)})
    tu._pool_trials[0] = 2.0 ** 30 + 1
    with pytest.raises(OverflowError):
        tu._pool_arrays()


class _DriftJax(q.SimplePrecessionModel):
    def update_timestep(self, key, modelparams, expparams):
        return modelparams[:, :, None]


class _DriftTorch(qt.SimplePrecessionModel):
    def update_timestep(self, generator, modelparams, expparams):
        return modelparams[:, :, None]


class _NoDensity(qt.Distribution):
    """A prior with neither a density nor a flat support."""

    n_rvs = 1

    def sample(self, generator, n=1):
        return torch.rand((n, 1), generator=generator)


class _ThreeJax(q.FiniteOutcomeModel):
    n_modelparams = 1
    expparams_dtype = [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 3

    def are_models_valid(self, modelparams):
        return jnp.ones(modelparams.shape[0], bool)


class _ThreeTorch(qt.FiniteOutcomeModel):
    n_modelparams = 1
    expparams_dtype = [("t", "float32")]

    def n_outcomes(self, expparams=None):
        return 3

    def are_models_valid(self, modelparams):
        return torch.ones(modelparams.shape[0], dtype=torch.bool)


_COIN = (lambda: q.BinomialModel(q.CoinModel(), n_meas_max=4),
         lambda: qt.BinomialModel(qt.CoinModel(), n_meas_max=4))
_REFUSALS = {
    "waste-free without the compressed record": (
        _COIN, 64, {"waste_free_stages": 8}, "compress_mcmc_record"),
    "stages that do not divide n": (
        _COIN, 100, {"compress_mcmc_record": True, "waste_free_stages": 8},
        "divide"),
    "waste-free with the error policy": (
        _COIN, 64, {"compress_mcmc_record": True, "waste_free_stages": 8,
                    "zero_weight_policy": "error"}, "zero_weight_policy"),
    "unknown waste-free kernel": (
        _COIN, 64, {"compress_mcmc_record": True, "waste_free_stages": 8,
                    "waste_free_kernel": "hmc", "zero_weight_policy": "reset"},
        "waste_free_kernel"),
    "compressed record without moves": (
        _COIN, 64, {"compress_mcmc_record": True}, "n_mcmc_moves"),
    "compressed record of a three-outcome model": (
        (_ThreeJax, _ThreeTorch), 64,
        {"n_mcmc_moves": 2, "compress_mcmc_record": True}, "two-outcome"),
    "unknown method": (
        _COIN, 64, {"n_mcmc_moves": 2, "mcmc_method": "hmc"},
        "unknown MCMC method"),
    "adaptation with waste-free": (
        _COIN, 100, {"waste_free_stages": 10, "compress_mcmc_record": True,
                     "mcmc_adapt": True, "zero_weight_policy": "reset"},
        "waste-free"),
    "moves on a time-dependent model": (
        (_DriftJax, _DriftTorch), 64, {"n_mcmc_moves": 2}, "time-dependent"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_option_validation_matches_jax(case):
    (jmodel, tmodel), n, kw, match = _REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        q.SMCUpdater(jmodel(), n, q.UniformDistribution([[0.0, 1.0]]), **kw)
    with pytest.raises(ValueError, match=match):
        qt.SMCUpdater(tmodel(), n, qt.UniformDistribution([[0.0, 1.0]]),
                      device="cpu", **kw)


def test_moves_refuse_an_intractable_prior_like_jax():
    match = "neither log_pdf nor is_flat_on_support"
    with pytest.raises(ValueError, match=match):
        q.SMCUpdater(q.CoinModel(), 4, q.ParticleDistribution(
            jnp.zeros((4, 1)), jnp.ones(4) / 4), n_mcmc_moves=2)
    with pytest.raises(ValueError, match=match):
        qt.SMCUpdater(qt.CoinModel(), 4, _NoDensity(), n_mcmc_moves=2,
                      device="cpu")


@pytest.mark.parametrize("moves", [0, 3])
@pytest.mark.parametrize("stages", [0, 8])
@pytest.mark.parametrize("canonicalize", [True, False])
def test_tolerant_resampler_rule_matches_jax(moves, stages, canonicalize):
    """The default Liu-West resampler skips its own strict projection
    exactly when moves run and re-project: at least one strict projection
    per resample-move event."""
    kw = dict(n_mcmc_moves=moves, waste_free_stages=stages,
              mcmc_canonicalize=canonicalize, zero_weight_policy="reset",
              compress_mcmc_record=moves > 0 or stages > 0)
    ju = q.SMCUpdater(q.CoinModel(), 64, q.UniformDistribution([0, 1]), **kw)
    tu = qt.SMCUpdater(qt.CoinModel(), 64, qt.UniformDistribution([0, 1]),
                       device="cpu", **kw)
    assert tu.resampler.canonicalize == ju.resampler.canonicalize
    assert tu.resampler.canonicalize == (not (moves > 0 and stages == 0
                                              and canonicalize))


@pytest.mark.parametrize("method,adapt", [("mala", False), ("mala", True),
                                          ("rwm", True)])
def test_initial_scale_matches_jax_and_takes_an_explicit_2_38(method, adapt):
    """With no proposal scale both packages seed the method's constant; a
    number seeds the scale itself, 2.38 included (the JAX updater reads
    2.38 as "unset" and would seed MALA's 1.65)."""
    d = 3
    prior_j = q.UniformDistribution([[0.0, 1.0]] * d)
    prior_t = qt.UniformDistribution([[0.0, 1.0]] * d)

    class JaxModel(q.CoinModel):
        n_modelparams = d

    class TorchModel(qt.CoinModel):
        n_modelparams = d

    kw = dict(n_mcmc_moves=2, mcmc_method=method, mcmc_adapt=adapt)
    ju = q.SMCUpdater(JaxModel(), 16, prior_j, **kw)
    tu = qt.SMCUpdater(TorchModel(), 16, prior_t, device="cpu", **kw)
    assert tu._mcmc_log_scale0 == ju._mcmc_log_scale0
    assert tu.mcmc_target_accept == ju.mcmc_target_accept
    ju5 = q.SMCUpdater(JaxModel(), 16, prior_j, mcmc_proposal_scale=5.0, **kw)
    tu5 = qt.SMCUpdater(TorchModel(), 16, prior_t, mcmc_proposal_scale=5.0,
                        device="cpu", **kw)
    assert tu5._mcmc_log_scale0 == ju5._mcmc_log_scale0
    tu238 = qt.SMCUpdater(TorchModel(), 16, prior_t,
                          mcmc_proposal_scale=2.38, device="cpu", **kw)
    root = 6.0 if method == "mala" else 2.0
    assert tu238._mcmc_log_scale0 == pytest.approx(
        math.log(2.38) - math.log(d) / root, abs=1e-12)
    assert tu238._mcmc_log_scale == tu238._mcmc_log_scale0


_COUNTS = [14, 15, 13, 14, 14]
_MOVES = {
    "fixed, full record": dict(n_mcmc_moves=5),
    "fixed, compressed": dict(n_mcmc_moves=5, compress_mcmc_record=True),
    "adaptive MALA, compressed": dict(n_mcmc_moves=5, mcmc_method="mala",
                                      mcmc_adapt=True,
                                      compress_mcmc_record=True),
    "adaptive RWM, full record": dict(n_mcmc_moves=5, mcmc_adapt=True,
                                      mcmc_canonicalize=False),
    "waste-free, rwm": dict(compress_mcmc_record=True, waste_free_stages=8,
                            zero_weight_policy="reset"),
    "waste-free, pcn with a Liu-West seed": dict(
        compress_mcmc_record=True, waste_free_stages=8,
        waste_free_kernel="pcn", waste_free_lw_seed=0.98,
        waste_free_beta=0.5, zero_weight_policy="reset"),
}


@pytest.mark.parametrize("case", sorted(_MOVES))
def test_updater_moves_reach_the_conjugate_posterior(case):
    kw = _MOVES[case]
    model = qt.BinomialModel(qt.CoinModel(), n_meas_max=20)
    u = qt.SMCUpdater(model, 4096, qt.UniformDistribution([[0.0, 1.0]]),
                      seed=5, resample_thresh=0.9, device="cpu", **kw)
    for count in _COUNTS:
        u.update(count, {"exp_num": torch.zeros(1, dtype=torch.int32),
                         "n_meas": torch.tensor([20])})
    ref = st.beta(71, 31)
    assert u.resample_count >= 1
    assert abs(float(u.est_mean()[0]) - ref.mean()) < 0.02
    assert abs(math.sqrt(float(u.est_covariance_mtx()[0, 0]))
               - ref.std()) < 0.015
    if u.n_mcmc_moves > 0:
        assert len(u.mcmc_acceptance_record) == u.resample_count
        assert all(0.0 < a < 1.0 for a in u.mcmc_acceptance_record)
    if u.mcmc_adapt:
        assert u._mcmc_adapt_t == u.n_mcmc_moves * u.resample_count
        assert u._mcmc_log_scale != u._mcmc_log_scale0
    assert len(u._pool_eps) == (1 if u.compress_mcmc_record else 0)
    assert len(u._eps_record) == (0 if u.compress_mcmc_record else 5)


def test_waste_free_follows_check_for_resample():
    """A caller that suppresses the resample gets no waste-free
    resample-move; the record still grows."""
    u = qt.SMCUpdater(qt.BinomialModel(qt.CoinModel(), n_meas_max=20), 64,
                      qt.UniformDistribution([[0.0, 1.0]]), seed=1,
                      resample_thresh=1.0, compress_mcmc_record=True,
                      waste_free_stages=8, zero_weight_policy="reset",
                      device="cpu")
    eps = {"exp_num": torch.zeros(1, dtype=torch.int32),
           "n_meas": torch.tensor([20])}
    u.update(14, eps, check_for_resample=False)
    assert u.resample_count == 0 and u._n_record == 1
    u.update(14, eps)
    assert u.resample_count == 1 and u.just_resampled
    np.testing.assert_allclose(u.particle_weights.numpy(), 1.0 / 64)
