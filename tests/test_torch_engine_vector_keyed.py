"""The port's engine with vector outcomes and keyed (Monte-Carlo)
likelihoods, against the JAX package and exact references.

* Vector outcomes (``MultinomialModel`` count vectors): one ``update``
  equals the scipy multinomial posterior at atol 1e-5 (the JAX package's
  ``test_multinomial_smc_update_vector_outcomes``) and JAX's weights on
  the same particles at atol 1e-6; ``batch_update`` takes a (T, k)
  record and equals the ``update`` loop to the bit; the full record
  stacks the vectors, its grouped log-likelihood equals the per-step sum
  and JAX's ``record_log_likelihood`` at rtol 1e-5, and full-record moves
  run over it.
* Keyed likelihoods (``wants_likelihood_key``): every update draws fresh
  noise from the updater's generator (the JAX package's
  ``test_poisoned_noise_fresh_per_step``); the design scorers draw from
  a stream of their own (fresh on every call, the update's stream left
  where it was) and, at zero noise, equal the plain model's scores and
  JAX's (rtol 1e-5); the paths that need a deterministic likelihood
  refuse keyed models with ``ValueError``, as JAX's do; full-record moves
  re-estimate both sides of each ratio (MCWM).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multinomial as sp_multinomial

import qinfer_tpu as q
import qinfer_tpu.rejuvenation as jrj
import qinfer_tpu_torch as qt
import qinfer_tpu_torch.rejuvenation as trj
from qinfer_tpu_torch.convert import state_from_numpy
from qinfer_tpu_torch.smc import _lift_outcome


def _jax_state_arrays(u):
    st = u.state
    return {f: np.asarray(getattr(st, f)) for f in st._fields if f != "key"}


# -- vector outcomes -----------------------------------------------------------

@pytest.mark.parametrize("k, n_meas, outcome", [
    (3, 12, [6, 4, 2]), (3, 12, [0, 12, 0]), (4, 9, [2, 2, 2, 3]),
    (6, 30, [5, 5, 5, 5, 5, 5])])
def test_torch_multinomial_update_matches_scipy_and_jax(k, n_meas, outcome):
    jm = q.MultinomialModel(q.NDieModel(k), n_meas_max=n_meas)
    tm = qt.MultinomialModel(qt.NDieModel(k), n_meas_max=n_meas)
    ju = q.SMCUpdater(jm, 300, q.MVUniformDistribution(k), seed=0)
    tu = qt.SMCUpdater(tm, 300, qt.MVUniformDistribution(k), seed=0,
                       device="cpu")
    tu.state = state_from_numpy(_jax_state_arrays(ju), device="cpu")
    eps = {"exp_num": np.array([0], np.int32),
           "n_meas": np.array([n_meas], np.int32)}
    tu.update(np.array(outcome), eps, check_for_resample=False)
    ju.update(jnp.array(outcome), {f: jnp.asarray(v) for f, v in eps.items()},
              check_for_resample=False)
    x = tu.particle_locations.numpy().astype(np.float64)
    L = np.array([sp_multinomial.pmf(outcome, n_meas, p / p.sum())
                  for p in x])
    expect = L / L.sum()
    np.testing.assert_allclose(tu.particle_weights.numpy(), expect,
                               atol=1e-5)
    np.testing.assert_allclose(tu.particle_weights.numpy(),
                               np.asarray(ju.particle_weights), atol=1e-6)
    assert tu.data_record[-1].tolist() == list(outcome)


def test_torch_multinomial_batch_update_is_the_update_loop():
    """A (T, k) record through ``batch_update`` equals the ``update`` loop
    with the same ESS gate, to the bit, resamples included."""
    m = qt.MultinomialModel(qt.NDieModel(3), n_meas_max=20)
    truth = torch.tensor([[0.2, 0.3, 0.5]])
    g = torch.Generator()
    g.manual_seed(1)
    T = 12
    eps = {"exp_num": torch.zeros(T, dtype=torch.int32),
           "n_meas": torch.full((T,), 20, dtype=torch.int32)}
    outs = m.simulate_experiment(g, truth, eps)[0]
    assert outs.shape == (T, 3)
    a = qt.SMCUpdater(m, 2000, qt.MVUniformDistribution(3), seed=4,
                      device="cpu")
    b = qt.SMCUpdater(m, 2000, qt.MVUniformDistribution(3), seed=4,
                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        norms = a.batch_update(outs, eps, resample_interval=2)
        for i in range(T):
            b.update(outs[i], {f: v[i:i + 1] for f, v in eps.items()},
                     check_for_resample=i % 2 == 1)
    assert a.resample_count == b.resample_count >= 1
    assert torch.equal(a.particle_weights, b.particle_weights)
    assert torch.equal(a.particle_locations, b.particle_locations)
    np.testing.assert_array_equal(norms, b.normalization_record)
    est = a.est_mean().numpy()
    assert np.all(np.abs(est - truth[0].numpy()) < 0.1)


def test_lift_outcome_shapes():
    scalar = qt.BinomialModel(qt.SimplePrecessionModel())
    vector = qt.MultinomialModel(qt.NDieModel(3))
    assert _lift_outcome(scalar, torch.tensor(3)).shape == (1,)
    assert _lift_outcome(scalar, torch.tensor([[3]])).shape == (1,)
    assert _lift_outcome(vector, torch.tensor([1, 2, 3])).shape == (1, 3)
    assert _lift_outcome(vector, torch.tensor([[1, 2, 3]])).shape == (1, 3)


def test_multinomial_record_stacks_vectors_and_moves_run_over_it():
    """The full record of count vectors: ``_record_arrays`` stacks (T, k);
    the grouped record log-likelihood equals the sum of the steps' own
    log-likelihoods and JAX's ``record_log_likelihood``; Metropolis moves
    after each resample run over it and keep the particles valid."""
    m = qt.MultinomialModel(qt.NDieModel(3), n_meas_max=10)
    # the updater canonicalizes the box draws onto the simplex
    prior = qt.UniformDistribution([[0.0, 1.0]] * 3)
    u = qt.SMCUpdater(m, 1000, prior, seed=2, device="cpu", n_mcmc_moves=2)
    g = torch.Generator()
    g.manual_seed(3)
    T = 8
    eps = {"exp_num": torch.zeros(T, dtype=torch.int32),
           "n_meas": torch.full((T,), 10, dtype=torch.int32)}
    outs = m.simulate_experiment(g, torch.tensor([[0.6, 0.3, 0.1]]), eps)[0]
    outs[3] = outs[1]  # a repeated vector shares a record group
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        u.batch_update(outs, eps, resample_interval=1)
    rec_outs, rec_eps = u._record_arrays()
    assert torch.equal(rec_outs, outs) and rec_eps["n_meas"].shape == (T,)
    assert u.resample_count >= 1
    assert len(u.mcmc_acceptance_record) == u.resample_count
    assert all(0.0 <= a <= 1.0 for a in u.mcmc_acceptance_record)
    assert bool(m.are_models_valid(u.particle_locations).all())
    x = u.particle_locations
    got = trj.record_log_likelihood(m, x, outs, eps,
                                    torch.ones(T, dtype=torch.bool))
    per_step = sum(torch.log(torch.clamp_min(m.likelihood(
        outs[i:i + 1], x, {f: v[i:i + 1] for f, v in eps.items()})[0, :, 0],
        1e-37)) for i in range(T))
    torch.testing.assert_close(got, per_step, rtol=1e-5, atol=1e-4)
    jm = q.MultinomialModel(q.NDieModel(3), n_meas_max=10)
    want = jrj.record_log_likelihood(
        jm, jnp.asarray(x.numpy()), jnp.asarray(outs.numpy()),
        {f: jnp.asarray(v.numpy()) for f, v in eps.items()},
        jnp.ones(T, bool))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


# -- keyed likelihoods in the update -------------------------------------------

def test_torch_poisoned_noise_is_fresh_every_step():
    """Port of ``test_poisoned_noise_fresh_per_step``: identical steps give
    different normalizations; the update's noise comes from the updater's
    generator, so a seed replays it."""
    def run(seed):
        u = qt.SMCUpdater(qt.PoisonedModel(qt.SimplePrecessionModel(),
                                           tol=0.02, seed=0),
                          200, qt.UniformDistribution([[0, 1]]), seed=seed,
                          zero_weight_policy="reset", device="cpu")
        return u, u.batch_update(np.zeros(8, np.int32),
                                 {"t": np.full(8, 1.0, np.float32)})

    (a, na), (b, nb), (_, nc) = run(0), run(0), run(1)
    assert len(np.unique(np.round(na, 8))) > 4
    np.testing.assert_array_equal(na, nb)
    assert torch.equal(a.particle_weights, b.particle_weights)
    assert not np.array_equal(na, nc)


def _keyed_updater(pkg, tol, device=None):
    model = pkg.PoisonedModel(pkg.SimplePrecessionModel(), tol=tol)
    kw = {} if device is None else {"device": device}
    return pkg.SMCUpdater(model, 500, pkg.UniformDistribution([[0, 1]]),
                          seed=5, **kw)


@pytest.mark.parametrize("score", ["expected_information_gain",
                                   "bayes_risk"])
def test_keyed_design_scores_are_fresh_and_leave_the_update_stream(score):
    """The scorers of a keyed model draw from the updater's design stream:
    two calls differ, and an update after scoring equals an update without
    it (the update's generator untouched)."""
    eps = {"t": torch.tensor([0.5, 1.0, 2.0, 4.0])}
    a = _keyed_updater(qt, 0.05, "cpu")
    b = _keyed_updater(qt, 0.05, "cpu")
    s1 = getattr(a, score)(eps)
    s2 = getattr(a, score)(eps, candidate_chunk=3)
    assert s1.shape == s2.shape == (4,) and bool(torch.isfinite(s1).all())
    assert not torch.equal(s1, s2)
    hyp = a.hypothetical_update(torch.tensor([0, 1]), eps)
    assert hyp.shape == (2, 4, 500)
    for u in (a, b):
        u.update(torch.tensor([0]), {"t": torch.tensor([1.0])})
    assert torch.equal(a.particle_weights, b.particle_weights)


@pytest.mark.parametrize("score", ["expected_information_gain",
                                   "bayes_risk"])
def test_keyed_design_scores_at_zero_noise_equal_the_plain_model(score):
    eps_np = np.array([0.5, 1.0, 2.0, 4.0, 9.0], np.float32)
    tu = _keyed_updater(qt, 0.0, "cpu")
    ju = _keyed_updater(q, 0.0)
    tu.state = state_from_numpy(_jax_state_arrays(ju), device="cpu")
    plain = qt.SMCUpdater(qt.SimplePrecessionModel(), 500,
                          qt.UniformDistribution([[0, 1]]), device="cpu")
    plain.state = tu.state
    got = getattr(tu, score)({"t": torch.as_tensor(eps_np)})
    assert torch.equal(got, getattr(plain, score)(
        {"t": torch.as_tensor(eps_np)}))
    want = getattr(ju, score)({"t": jnp.asarray(eps_np)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_ale_updater_scores_and_tracks():
    """ALE through the updater: design scores fresh on every call (the
    JAX package's ``test_ale_design_scores_get_fresh_noise``), and a short
    PGH run lands near the truth."""
    model = qt.ALEApproximateModel(qt.CoinModel(), error_tol=0.2,
                                   min_samp=8, samp_step=8)
    u = qt.SMCUpdater(model, 64, qt.UniformDistribution([[0.2, 0.8]]),
                      seed=0, device="cpu")
    eps = {"exp_num": torch.tensor([0], dtype=torch.int32)}
    assert len({float(u.bayes_risk(eps)[0]) for _ in range(6)}) > 1
    sim = qt.SimplePrecessionModel()
    ale = qt.ALEApproximateModel(sim, error_tol=0.05)
    u = qt.SMCUpdater(ale, 1000, qt.UniformDistribution([[0, 1]]), seed=1,
                      device="cpu")
    pgh = qt.PGH(u)
    g = torch.Generator()
    g.manual_seed(2)
    for k in range(40):
        e = pgh(k)
        u.update(sim.simulate_experiment(g, torch.tensor([[0.7]]), e)
                 .reshape(-1), e)
    est = float(u.est_mean()[0])
    sd = float(u.est_covariance_mtx()[0, 0]) ** 0.5
    assert abs(est - 0.7) <= 4 * sd + 1e-3
    assert len(ale.rounds) == 40


# -- refusals and Monte Carlo within Metropolis --------------------------------

def _refusal_calls(pkg, rj, gen):
    keyed = pkg.PoisonedModel(pkg.SimplePrecessionModel(), tol=0.01)
    prior = pkg.UniformDistribution([[0, 1]])
    host = pkg is q
    x = np.full((8, 1), 0.5) if host else torch.full((8, 1), 0.5)
    w = np.full((8,), 1 / 8) if host else torch.full((8,), 1 / 8)
    counts = (np.zeros(2, np.int32) if host
              else torch.zeros(2, dtype=torch.int32))
    pool = {"t": np.ones(2, np.float32) if host else torch.ones(2)}
    return {
        "binomial_moves": lambda: rj.mcmc_rejuvenate_binomial(
            keyed, prior, gen, x, counts, counts, pool, 1),
        "binomial_adaptive": lambda: rj.mcmc_rejuvenate_binomial_adaptive(
            keyed, prior, gen, x, counts, counts, pool, 1, 0.0, 0),
        "waste_free_binomial": lambda: rj.waste_free_rejuvenate_binomial(
            keyed, prior, gen, w, x, counts, counts, pool, 2),
        "waste_free_full": lambda: rj.waste_free_rejuvenate(
            keyed, prior, gen, w, x, counts, pool, counts > -1, 2),
        "updater_compressed": lambda: pkg.SMCUpdater(
            keyed, 8, prior, n_mcmc_moves=1, compress_mcmc_record=True,
            **({} if host else {"device": "cpu"})),
        "updater_mala": lambda: pkg.SMCUpdater(
            keyed, 8, prior, n_mcmc_moves=1, mcmc_method="mala",
            **({} if host else {"device": "cpu"})),
    }


@pytest.mark.parametrize("case", list(_refusal_calls(qt, trj, None)))
def test_keyed_models_are_refused_where_jax_refuses_them(case):
    with pytest.raises(ValueError):
        _refusal_calls(q, jrj, jax.random.key(0))[case]()
    with pytest.raises(ValueError):
        _refusal_calls(qt, trj, torch.Generator())[case]()


@pytest.mark.parametrize("adapt", [False, True])
def test_keyed_full_record_moves_reestimate_both_sides(adapt):
    """Full-record random-walk moves over a keyed likelihood (MCWM): each
    sweep re-estimates both sides with common random numbers, so at zero
    noise the chain is the deterministic chain's target; moves run after
    each resample and keep the particles valid, and MALA is refused."""
    model = qt.PoisonedModel(qt.SimplePrecessionModel(), tol=0.0)
    u = qt.SMCUpdater(model, 800, qt.UniformDistribution([[0, 1]]), seed=3,
                      device="cpu", n_mcmc_moves=3, mcmc_adapt=adapt)
    g = torch.Generator()
    g.manual_seed(4)
    for k in range(12):
        t = torch.tensor([1.3 ** k])
        o = qt.SimplePrecessionModel().simulate_experiment(
            g, torch.tensor([[0.42]]), {"t": t})
        u.update(o.reshape(-1), {"t": t})
    assert u.resample_count >= 1
    assert len(u.mcmc_acceptance_record) == u.resample_count
    assert all(0.0 < a <= 1.0 for a in u.mcmc_acceptance_record)
    assert bool(model.are_models_valid(u.particle_locations).all())
    assert abs(float(u.est_mean()[0]) - 0.42) < 0.1
    x = u.particle_locations
    with pytest.raises(ValueError):
        trj._mh_moves_adaptive(model, u.prior, g, x, lambda xx, gg=None:
                               torch.zeros(xx.shape[0]), 1, 0.0, 0, "mala",
                               0.5, True)
