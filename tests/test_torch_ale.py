"""Parity of the port's approximate likelihoods against the JAX package:
``ALEApproximateModel`` and the hedged estimators, and ``PoisonedModel``.

A Monte-Carlo likelihood cannot match JAX draw for draw (threefry and
Philox streams differ), so:

* the sample budget ``n_samples`` equals JAX's exactly, and the hedged
  estimators equal JAX's at rtol 1e-6;
* ALE estimates, adaptive and static, lie within 4·``error_tol`` of the
  exact likelihood;
* ``PoisonedModel`` with ``tol=0`` equals the underlying likelihood
  exactly, as JAX's does; with noise, the noise's standard deviation (tol
  and ALE modes) agrees with JAX's within 4 Monte-Carlo errors at 2·10⁵
  draws.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as q
import qinfer_tpu_torch as qt


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("kw", [
    dict(error_tol=0.02), dict(error_tol=0.01), dict(error_tol=0.05,
                                                     samp_step=50),
    dict(error_tol=0.2, min_samp=200, samp_step=10),
    dict(error_tol=0.01, max_samp=500), dict(error_tol=1.0, min_samp=1,
                                             samp_step=1, max_samp=1),
    dict(error_tol=0.03, adapt_hedge=0.0, samp_step=7)])
def test_ale_budget_equals_jax(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = q.ALEApproximateModel(q.SimplePrecessionModel(), **kw)
        tm = qt.ALEApproximateModel(qt.SimplePrecessionModel(), **kw)
    assert tm.n_samples == jm.n_samples


def test_ale_estimators_and_cap_warning_match_jax():
    n = np.arange(0, 101, 7, dtype=np.float32)
    for hedge in (0.0, 0.509):
        p_j = q.binom_est_p(jnp.asarray(n), 100, hedge)
        p_t = qt.binom_est_p(torch.as_tensor(n), 100, hedge)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
        np.testing.assert_allclose(
            qt.binom_est_error(p_t, 100, hedge).numpy(),
            np.asarray(q.binom_est_error(p_j, 100, hedge)), rtol=1e-6)
    with pytest.warns(qt.ApproximationWarning):
        qt.ALEApproximateModel(qt.SimplePrecessionModel(), error_tol=0.01,
                               max_samp=100)
    with pytest.raises(ValueError):
        qt.ALEApproximateModel(qt.SimplePrecessionModel(), error_tol=0.0)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("tol", [0.05, 0.02])
def test_ale_estimates_within_four_tolerances_of_the_exact(adaptive, tol):
    sim = qt.SimplePrecessionModel()
    m = qt.ALEApproximateModel(sim, error_tol=tol, adaptive=adaptive)
    rng = np.random.default_rng(int(tol * 100))
    mps = torch.as_tensor(rng.uniform(0, 1, (200, 1)).astype(np.float32))
    eps = {"t": torch.tensor([0.5, 3.0, 11.0])}
    outs = torch.tensor([0, 1], dtype=torch.int32)
    est = m.likelihood(outs, mps, eps, generator=_gen(5))
    exact = sim.likelihood(outs, mps, eps)
    assert est.shape == exact.shape == (2, 200, 3)
    assert float((est - exact).abs().max()) <= 4 * tol
    max_rounds = -(-m.n_samples // m.samp_step) if adaptive else 1
    assert 1 <= m.rounds[-1] <= max_rounds


def test_ale_adaptive_rounds_stop_early_and_respect_min_samp():
    """Port of ``test_ale_adaptive_chunking_stops_early`` and
    ``test_ale_respects_min_samp_floor``: easy cells stop before the
    budget, and never below ``min_samp``."""
    coin = qt.CoinModel()
    m = qt.ALEApproximateModel(coin, error_tol=0.05, samp_step=50)
    L = m.likelihood(torch.tensor([0]), torch.tensor([[0.9], [0.5], [0.1]]),
                     {"exp_num": torch.tensor([0])}, generator=_gen(0))
    np.testing.assert_allclose(L[0, :, 0].numpy(), [0.9, 0.5, 0.1],
                               atol=0.12)
    easy = qt.ALEApproximateModel(coin, error_tol=0.05, samp_step=10)
    easy.likelihood(torch.tensor([0]), torch.tensor([[0.0], [1.0]]),
                    {"exp_num": torch.tensor([0])}, generator=_gen(1))
    assert easy.rounds[-1] == 2 < -(-easy.n_samples // easy.samp_step)
    floor = qt.ALEApproximateModel(coin, error_tol=0.2, min_samp=200,
                                   samp_step=10)
    L = float(floor.likelihood(torch.tensor([0]), torch.tensor([[0.0]]),
                               {"exp_num": torch.tensor([0])},
                               generator=_gen(2))[0, 0, 0])
    assert 0.509 / L - 2 * 0.509 >= 190 and floor.rounds[-1] >= 20


def test_ale_single_sample_budget_and_delegation():
    """Port of ``test_ale_single_sample_budget`` and
    ``test_ale_delegates_time_dependence``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = qt.ALEApproximateModel(qt.SimplePrecessionModel(),
                                   error_tol=1.0, min_samp=1, samp_step=1,
                                   max_samp=1)
    assert m.n_samples == 1
    L = m.likelihood(torch.tensor([0]), torch.full((4, 1), 0.5),
                     {"t": torch.tensor([1.0])})
    assert L.shape == (1, 4, 1) and bool(torch.isfinite(L).all())
    walk = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                              qt.NormalDistribution(0.0, 1e-4))
    assert qt.ALEApproximateModel(walk, error_tol=0.2).is_time_dependent
    assert not qt.ALEApproximateModel(qt.SimplePrecessionModel(),
                                      error_tol=0.2).is_time_dependent
    # without a generator the model's own stream advances: fresh noise
    a = m.likelihood(torch.tensor([0]), torch.full((64, 1), 0.5),
                     {"t": torch.tensor([1.0])})
    b = m.likelihood(torch.tensor([0]), torch.full((64, 1), 0.5),
                     {"t": torch.tensor([1.0])})
    assert not torch.equal(a, b)


def test_poisoned_at_zero_tol_is_the_underlying_model_in_both_packages():
    rng = np.random.default_rng(4)
    mps = rng.uniform(0, 1, (50, 1)).astype(np.float32)
    t = rng.uniform(0.5, 10, 6).astype(np.float32)
    outs = np.array([0, 1], np.int32)
    jp = q.PoisonedModel(q.SimplePrecessionModel(), tol=0.0)
    tp = qt.PoisonedModel(qt.SimplePrecessionModel(), tol=0.0)
    want = np.asarray(q.SimplePrecessionModel().likelihood(
        jnp.asarray(outs), jnp.asarray(mps), {"t": jnp.asarray(t)}))
    np.testing.assert_array_equal(np.asarray(jp.likelihood(
        jnp.asarray(outs), jnp.asarray(mps), {"t": jnp.asarray(t)})), want)
    base = qt.SimplePrecessionModel().likelihood(
        torch.as_tensor(outs), torch.as_tensor(mps), {"t": torch.as_tensor(t)})
    got = tp.likelihood(torch.as_tensor(outs), torch.as_tensor(mps),
                        {"t": torch.as_tensor(t)}, generator=_gen(0))
    assert torch.equal(got, base)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2.4e-7)


@pytest.mark.parametrize("mode", [dict(tol=0.02), dict(tol=0.1),
                                  dict(n_samples=100, hedge=0.5),
                                  dict(n_samples=1000)])
def test_poisoned_noise_sd_matches_jax(mode):
    """The noise about L = ½ (t = π/2 at ω = 1, away from the [0, 1]
    clip): its standard deviation within 4 Monte-Carlo errors of JAX's."""
    n = 200_000
    mps = np.ones((n, 1), np.float32)
    t = np.array([np.pi / 2], np.float32)
    jp = q.PoisonedModel(q.SimplePrecessionModel(), **mode)
    tp = qt.PoisonedModel(qt.SimplePrecessionModel(), **mode)
    want = np.asarray(jp.likelihood(jnp.array([0]), jnp.asarray(mps),
                                    {"t": jnp.asarray(t)},
                                    key=jax.random.key(1)))[0, :, 0]
    got = tp.likelihood(torch.tensor([0]), torch.as_tensor(mps),
                        {"t": torch.as_tensor(t)},
                        generator=_gen(1))[0, :, 0].numpy()
    sd_j, sd_t = want.std(), got.std()
    se = np.hypot(sd_j, sd_t) / np.sqrt(2 * n)
    assert abs(sd_t - sd_j) <= 4 * se
    assert abs(got.mean() - 0.5) <= 4 * sd_t / np.sqrt(n)
