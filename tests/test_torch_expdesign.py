"""Experiment design of the port against the JAX package.

Inputs come from numpy with a fixed seed (for tomography: one JAX BCSZ
prior draw), and the same weights, particles and candidates go through the
JAX function and the port's.

Tolerances. The scorers (information gain, Bayes risk, hypothetical
update): rtol 1e-5, atol 1e-6 in float32 (XLA's reduction order against
torch's). Chunked scoring against unchunked: the same, since only the
width of the candidate axis changes. ``FiniteDifference``: 1e-12 (the same
float64 host code). The ``PoolDesigner`` schedule: exact. The selection
policies' pick frequencies: a chi-square test against the analytic rates
at α = 1e-3. The designers' picks: equal, where the top two scores differ
by more than the score tolerance.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats
import torch

import qinfer_tpu as q
import qinfer_tpu.tomography as jtomo
from qinfer_tpu.expdesign import (ExperimentDesigner as JaxDesigner,
                                  PoolDesigner as JaxPoolDesigner)
from qinfer_tpu.finite_difference import FiniteDifference as JaxFD
from qinfer_tpu.smc import (_bayes_risk as jax_bayes_risk,
                            _expected_information_gain as jax_eig,
                            _hypothetical_update as jax_hyp)
from qinfer_tpu.tomography.expdesign import (
    BestOfKMetaheuristic as JaxBestOfK)

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import expdesign as ed
from qinfer_tpu_torch import tomography as ttomo
from qinfer_tpu_torch.smc import (_bayes_risk, _expected_information_gain,
                                  _hypothetical_update)

RTOL, ATOL = 1e-5, 1e-6
N = 1500


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fiducials(basis):
    kets = np.asarray([[1, 0], [0, 1],
                       [1 / np.sqrt(2), 1 / np.sqrt(2)],
                       [1 / np.sqrt(2), 1j / np.sqrt(2)]], np.complex64)
    return np.stack([np.asarray(basis.state_to_modelparams(
        np.outer(k, k.conj()))) for k in kets]).astype(np.float32)


def _weights(rng, n):
    w = rng.random(n).astype(np.float32) ** 3 + 1e-4
    return (w / w.sum()).astype(np.float32)


def _case(name):
    """``(jax model, port model, weights, locations, candidates)`` on host
    NumPy, from seed 0."""
    rng = np.random.default_rng(0)
    if name == "process":
        jm = jtomo.ProcessTomographyModel(jtomo.pauli_basis(2),
                                          jtomo.pauli_basis(1))
        tm = ttomo.ProcessTomographyModel(ttomo.pauli_basis(2),
                                          ttomo.pauli_basis(1))
        x = np.array(jtomo.BCSZChoiDistribution(jm.basis).sample(
            jax.random.key(0), N))
        fid = _fiducials(jtomo.pauli_basis(1))
        eps = {"prep": np.repeat(fid, 4, axis=0),
               "meas": np.tile(fid, (4, 1))}
        return jm, tm, _weights(rng, N), x, eps
    x = rng.random((N, 1)).astype(np.float32)
    t = np.geomspace(0.5, 40.0, 12).astype(np.float32)
    if name == "precession":
        return (q.SimplePrecessionModel(), qt.SimplePrecessionModel(),
                _weights(rng, N), x, {"t": t})
    n_meas = np.asarray([1, 3, 8, 5, 2, 8, 7, 1, 4, 6, 8, 3], np.int32)
    return (q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=8),
            qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=8),
            _weights(rng, N), x, {"t": t, "n_meas": n_meas})


def _jax_eps(eps):
    return {k: jnp.asarray(v) for k, v in eps.items()}


def _torch_eps(eps):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in eps.items()}


def _grid(jm, eps):
    outcomes = jm.outcomes(_jax_eps(eps))
    mask = np.asarray(jm.outcome_mask(_jax_eps(eps))).astype(np.float32)
    return np.array(outcomes), mask


@pytest.mark.parametrize("name", ["precession", "binomial", "process"])
@pytest.mark.parametrize("scorer", ["information_gain", "bayes_risk",
                                    "hypothetical_update"])
def test_scorers_match_jax(name, scorer):
    jm, tm, w, x, eps = _case(name)
    outcomes, mask = _grid(jm, eps)
    if name == "binomial":
        assert not mask.all()  # padded outcome slots are masked
    jargs = (jnp.asarray(w), jnp.asarray(x), jnp.asarray(outcomes))
    targs = (torch.from_numpy(w), torch.from_numpy(x),
             torch.from_numpy(outcomes))
    if scorer == "hypothetical_update":
        want = jax_hyp(jm, *jargs, _jax_eps(eps))
        got = _hypothetical_update(tm, *targs, _torch_eps(eps))
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                       rtol=RTOL, atol=ATOL)
        return
    if scorer == "information_gain":
        want = jax_eig(jm, *jargs, jnp.asarray(mask), _jax_eps(eps))
        got = _expected_information_gain(tm, *targs, torch.from_numpy(mask),
                                         _torch_eps(eps))
    else:
        want = jax_bayes_risk(jm, *jargs, jnp.asarray(mask), _jax_eps(eps),
                              jm.Q)
        got = _bayes_risk(tm, *targs, torch.from_numpy(mask),
                          _torch_eps(eps), tm.Q)
    assert got.shape == (len(next(iter(eps.values()))),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _updaters(name, seed=0):
    """A JAX and a port updater holding the same weights and particles."""
    jm, tm, w, x, eps = _case(name)
    prior = ([[0.0, 1.0]],)
    if name == "process":
        jprior = jtomo.BCSZChoiDistribution(jm.basis)
        tprior = ttomo.BCSZChoiDistribution(tm.basis)
    else:
        jprior = q.UniformDistribution(*prior)
        tprior = qt.UniformDistribution(*prior)
    ju = q.SMCUpdater(jm, 16, jprior, seed=seed)
    ju.state = ju.state._replace(weights=jnp.asarray(w),
                                 locations=jnp.asarray(x))
    tu = qt.SMCUpdater(tm, 16, tprior, seed=seed, device="cpu")
    tu.state = dataclasses.replace(tu.state, weights=torch.from_numpy(w),
                                   locations=torch.from_numpy(x))
    tu._n_particles = ju._n_particles = N
    return ju, tu, eps


@pytest.mark.parametrize("chunk", [None, 3, 7])
@pytest.mark.parametrize("utility", ["information_gain", "bayes_risk"])
def test_candidate_chunk_equals_unchunked(chunk, utility):
    """A pool of 20 binomial candidates with mixed n_meas (so each chunk
    has its own outcome mask; 3 and 7 pad the pool)."""
    ju, tu, _ = _updaters("binomial")
    rng = np.random.default_rng(5)
    eps = {"t": rng.uniform(0.5, 30.0, 20).astype(np.float32),
           "n_meas": rng.integers(1, 9, 20).astype(np.int32)}
    score = {"information_gain": "expected_information_gain",
             "bayes_risk": "bayes_risk"}[utility]
    full = getattr(tu, score)(_torch_eps(eps))
    got = getattr(tu, score)(_torch_eps(eps), candidate_chunk=chunk)
    assert got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=RTOL,
                               atol=ATOL)
    want = getattr(ju, score)(_jax_eps(eps), candidate_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_updater_hypothetical_update_matches_jax():
    ju, tu, eps = _updaters("binomial")
    outcomes = np.arange(4)
    want = ju.hypothetical_update(jnp.asarray(outcomes), _jax_eps(eps),
                                  return_likelihood=True,
                                  return_normalization=True)
    got = tu.hypothetical_update(torch.from_numpy(outcomes), _torch_eps(eps),
                                 return_likelihood=True,
                                 return_normalization=True)
    assert [tuple(g.shape) for g in got] == [(4, 12, N), (4, N, 12), (4, 12)]
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=RTOL,
                                   atol=ATOL)
    single = tu.hypothetical_update(0, _torch_eps(eps))
    np.testing.assert_allclose(single.numpy(), got[0][:1].numpy())


def test_scoring_refuses_models_with_a_likelihood_stream():
    """Scoring no longer refuses a model whose likelihood draws from a
    stream (``wants_likelihood_key``): it hands the likelihood the
    updater's design generator, never the update's own, and a noiseless
    keyed model scores as the plain model does."""
    seen = []

    class Keyed(qt.SimplePrecessionModel):
        wants_likelihood_key = True

        def likelihood(self, outcomes, modelparams, expparams,
                       generator=None):
            seen.append(generator)
            return super().likelihood(outcomes, modelparams, expparams)

    u = qt.SMCUpdater(Keyed(), 64, qt.UniformDistribution([[0.0, 1.0]]),
                      device="cpu")
    plain = qt.SMCUpdater(qt.SimplePrecessionModel(), 64,
                          qt.UniformDistribution([[0.0, 1.0]]), device="cpu")
    eps = {"t": torch.tensor([1.0, 2.0])}
    got = u.expected_information_gain(eps)
    assert seen and all(g is not None and g is not u.generator for g in seen)
    assert torch.equal(got, plain.expected_information_gain(eps))


class _StubUpdater:
    """Just what a PoolDesigner reads: a model, the state's resample count
    (scripted) and the pool's scores (fixed), counting score calls."""

    def __init__(self, model, scores, device=None):
        self.model = model
        self.state = types.SimpleNamespace(resample_count=0)
        self.device = device
        self.scores = scores
        self.score_calls = 0

    def expected_information_gain(self, eps):
        self.score_calls += 1
        return self.scores


#: resample_count seen by each of 30 designer calls
_RESAMPLES = [0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
              5, 5, 5, 5, 5, 5, 5, 7, 7, 7]


def _schedule(designer, updater):
    rescored = []
    for rc in _RESAMPLES:
        updater.state.resample_count = rc
        before = designer.n_rescores
        designer()
        rescored.append(designer.n_rescores > before)
    return rescored


@pytest.mark.parametrize("interval", [1, 3, 4])
@pytest.mark.parametrize("on_resample", [True, False])
def test_pool_designer_rescore_schedule_matches_jax(interval, on_resample):
    scores = [0.1, 0.4, 0.3]
    t = np.asarray([1.0, 2.0, 3.0], np.float32)
    kw = dict(policy="greedy", rescore_interval=interval,
              rescore_on_resample=on_resample)
    ju = _StubUpdater(q.SimplePrecessionModel(), jnp.asarray(scores))
    tu = _StubUpdater(qt.SimplePrecessionModel(), torch.tensor(scores),
                      device="cpu")
    jd = JaxPoolDesigner(ju, {"t": jnp.asarray(t)}, **kw)
    td = ed.PoolDesigner(tu, {"t": torch.from_numpy(t)}, **kw)
    want, got = _schedule(jd, ju), _schedule(td, tu)
    assert got == want
    assert td.n_rescores == jd.n_rescores == tu.score_calls == ju.score_calls
    assert td()[1] == jd()[1] == 1
    assert float(td()[0]["t"][0]) == 2.0


def _frequencies(policy, scores, n_draws=20_000, **kw):
    g = torch.Generator().manual_seed(11)
    s = torch.tensor(scores)
    picks = [int(ed.select_candidate(g, s, policy=policy, **kw))
             for _ in range(n_draws)]
    return np.bincount(picks, minlength=len(scores)), n_draws


def _softmax_rates(scores, t):
    z = np.exp((np.asarray(scores) - np.max(scores)) / t)
    return z / z.sum()


def _egreedy_rates(scores, eps):
    p = np.full(len(scores), eps / len(scores))
    p[int(np.argmax(scores))] += 1.0 - eps
    return p


_SPREAD = [0.1, 0.5, 0.3, 0.2, 0.45]          # std/|mean| = 0.52
_FLAT = [1.00, 1.05, 1.02, 0.98, 1.04]        # std/|mean| = 0.026


@pytest.mark.parametrize("policy, scores, kw, rates", [
    ("egreedy", _SPREAD, dict(epsilon=0.25), _egreedy_rates(_SPREAD, 0.25)),
    ("softmax", _SPREAD, dict(temperature=0.1), _softmax_rates(_SPREAD,
                                                               0.1)),
    ("softmax", _SPREAD, {}, _softmax_rates(_SPREAD, np.std(_SPREAD))),
    ("auto", _FLAT, dict(epsilon=0.3), _egreedy_rates(_FLAT, 0.3)),
    ("auto", _SPREAD, dict(epsilon=0.3),
     _softmax_rates(_SPREAD, np.std(_SPREAD))),
])
def test_policy_pick_frequencies_match_their_rates(policy, scores, kw,
                                                   rates):
    counts, n = _frequencies(policy, scores, **kw)
    res = scipy.stats.chisquare(counts, n * rates)
    assert res.pvalue > 1e-3, (counts, n * rates)


def test_greedy_is_the_first_argmax_and_picks_are_0d_int64():
    s = torch.tensor([0.2, 0.7, 0.1, 0.7])
    g = torch.Generator().manual_seed(0)
    for policy in ("greedy", "egreedy", "softmax", "auto"):
        pick = ed.select_candidate(g, s, policy=policy)
        assert pick.shape == () and pick.dtype == torch.int64
    assert int(ed.select_candidate(None, s)) == 1
    with pytest.raises(ValueError):
        ed.select_candidate(g, s, policy="nope")


def test_finite_difference_matches_jax():
    def f(x):
        return np.sum(np.sin(x) * x ** 2)

    x = np.asarray([0.3, -1.2, 2.5])
    h = [1e-3, 1e-4, 1e-5]
    got = qt.FiniteDifference(f, 3, h=h)(x)
    want = JaxFD(f, 3, h=h)(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    exact = np.sin(x) * 2 * x + np.cos(x) * x ** 2
    np.testing.assert_allclose(got, exact, atol=1e-4)


def _posterior_updaters():
    """Precession updaters holding a posterior peaked near ω = 0.7."""
    ju, tu, _ = _updaters("precession")
    x = np.asarray(tu.state.locations)
    w = np.exp(-0.5 * ((x[:, 0] - 0.7) / 0.06) ** 2).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    ju.state = ju.state._replace(weights=jnp.asarray(w))
    tu.state = dataclasses.replace(tu.state, weights=torch.from_numpy(w))
    return ju, tu


def test_experiment_designer_grid_matches_jax():
    ju, tu = _posterior_updaters()
    guess = {"t": np.asarray([5.0], np.float32)}
    jd, td = JaxDesigner(ju), ed.ExperimentDesigner(tu, "grid")
    grid = np.linspace(0.5, 50.0, 64)
    want_risk, _ = jd._risk_of(_jax_eps(guess), "t", grid)
    got_risk, _ = td._risk_of(_torch_eps(guess), "t", grid)
    np.testing.assert_allclose(got_risk, want_risk, rtol=RTOL, atol=ATOL)
    want = jd.design_expparams_field(guess, "t")
    got = td.design_expparams_field(guess, "t")
    assert set(got) == {"t"} and got["t"].shape == (1,)
    assert float(got["t"][0]) == float(want["t"][0])
    # cost scaling: additive and multiplicative, as in JAX
    for kw in (dict(cost_scale_k=0.5), dict(cost_scale_k=0.5,
                                            cost_mult=True)):
        want = jd.design_expparams_field(guess, "t", **kw)
        got = td.design_expparams_field(guess, "t", **kw)
        assert float(got["t"][0]) == float(want["t"][0])


@pytest.mark.parametrize("algo", ["nm", "cg"])
def test_experiment_designer_nm_and_cg_do_not_lose_to_the_guess(algo):
    _, tu = _posterior_updaters()
    guess = {"t": torch.tensor([3.0])}
    d = ed.ExperimentDesigner(tu, algo)
    out = d.design_expparams_field(guess, "t", grad_h=1e-2,
                                   bounds=(0.1, None))
    risk_guess = d._risk_of(guess, "t", [3.0])[0][0]
    risk_out = d._risk_of(guess, "t", [float(out["t"][0])])[0][0]
    assert float(out["t"][0]) >= 0.1
    assert risk_out <= risk_guess


def test_experiment_designer_keeps_the_stored_best_guess():
    _, tu = _posterior_updaters()
    d = ed.ExperimentDesigner(tu, ed.OptimizationAlgorithms.GRID)
    first = d.design_expparams_field({"t": torch.tensor([5.0])}, "t",
                                     store_guess=True)
    # a window far from the optimum does worse: the stored guess returns
    worse = d.design_expparams_field({"t": torch.tensor([5.0])}, "t",
                                     store_guess=True, bounds=(400.0, 401.0))
    assert float(worse["t"][0]) == float(first["t"][0])
    d.new_exp()
    assert d._best_guess is None
    with pytest.raises(ValueError):
        ed.ExperimentDesigner(tu, "simplex")


class _FixedCandidates:
    """A base heuristic proposing a fixed sequence of experiments."""

    def __init__(self, cands):
        self.cands, self.i = cands, 0

    def propose(self, key_or_generator, weights, locations, idx_exp):
        c = {k: v[self.i:self.i + 1] for k, v in self.cands.items()}
        self.i += 1
        return c


@pytest.mark.parametrize("score", ["information_gain", "bayes_risk"])
def test_best_of_k_picks_the_same_candidate_as_jax(score):
    ju, tu, eps = _updaters("process")
    order = np.random.default_rng(2).permutation(16)[:8]
    cands = {k: v[order] for k, v in eps.items()}
    jb = JaxBestOfK(ju, _FixedCandidates(_jax_eps(cands)), k=8, score=score)
    tb_ = ttomo.BestOfKMetaheuristic(tu, _FixedCandidates(
        _torch_eps(cands)), k=8, score=score)
    want, got = jb(), tb_()
    scores = (tu.expected_information_gain(_torch_eps(cands))
              if score == "information_gain"
              else -tu.bayes_risk(_torch_eps(cands)))
    top = np.sort(scores.numpy())[-2:]
    assert top[1] - top[0] > RTOL * abs(top[1]) + ATOL  # a pick to compare
    for k in ("prep", "meas"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(NotImplementedError):
        tb_.propose(None, None, None, 0)


def test_best_of_k_other_fields_and_generator():
    """The k draws come from the updater's generator; other fields ride on
    every candidate."""
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 200,
                      qt.UniformDistribution([[0.0, 1.0]]), device="cpu")

    class Draw:
        def propose(self, generator, weights, locations, idx_exp):
            return {"t": torch.rand((1,), generator=generator) * 10}

    state = u.generator.get_state()
    h = ttomo.BestOfKMetaheuristic(u, Draw(), k=5,
                                   other_fields={"extra": 2.0})
    out = h()
    assert set(out) == {"t", "extra"} and float(out["extra"][0]) == 2.0
    u.generator.set_state(state)
    drawn = torch.rand((5,), generator=u.generator) * 10
    assert float(out["t"][0]) in drawn.tolist()


def test_design_from_candidates_matches_jax_and_auto_risk_raises():
    ju, tu, eps = _updaters("binomial")
    want_eps, want_idx = q.design_from_candidates(ju, _jax_eps(eps))
    got_eps, got_idx = ed.design_from_candidates(tu, _torch_eps(eps))
    assert isinstance(got_idx, int) and got_idx == want_idx
    assert float(got_eps["t"][0]) == float(want_eps["t"][0])
    g = torch.Generator().manual_seed(0)
    _, idx = ed.design_from_candidates(tu, _torch_eps(eps), g,
                                       policy="softmax", utility="risk")
    assert 0 <= idx < 12
    with pytest.raises(ValueError, match="auto"):
        ed.design_from_candidates(tu, _torch_eps(eps), g, policy="auto",
                                  utility="risk")
    with pytest.raises(ValueError, match="auto"):
        ed.PoolDesigner(tu, _torch_eps(eps), policy="auto", utility="risk")
    with pytest.raises(ValueError, match="stochastic"):
        ed.design_from_candidates(tu, _torch_eps(eps), policy="egreedy")
    with pytest.raises(ValueError):
        ed.design_from_candidates(tu, _torch_eps(eps), utility="cost")
    ed.PoolDesigner(tu, _torch_eps(eps), policy="softmax", utility="risk")()
