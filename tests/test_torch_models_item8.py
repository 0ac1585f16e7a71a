"""Parity of the port's remaining models and heuristics against the JAX
package: the multinomial pmf and draws, the die, inversion and noisy-coin
test models, the derived models (``MultinomialModel``, ``MLEModel``,
``RandomWalkModel``, ``GaussianRandomWalkModel``,
``ReferencedPoissonModel``), ``MultinomialDomain``, the simplex transforms
and host helpers, ``ExpSparseHeuristic`` and ``IdentityHeuristic``, and
the carry-over of a walk's parameters (``convert``).

Both packages get the same NumPy inputs from a seed. Deterministic
likelihoods are held at rtol 1e-5 in float32 (``lgamma``, ``exp``,
``log`` and ``cos`` of the two libraries differ by a few ulps), with atol
2.4e-7, two float32 ulps of 1, for the complements 1 − p near 0;
the learned walk's step, given the same standard normals, at rtol 1e-5;
draws by their moments within 4 Monte-Carlo errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as q
import qinfer_tpu_torch as qt
from qinfer_tpu_torch import convert

RTOL, ATOL = 1e-5, 2.4e-7


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _both(eps):
    """An expparams dict for each package from NumPy arrays."""
    return ({k: jnp.asarray(v) for k, v in eps.items()},
            {k: torch.as_tensor(v) for k, v in eps.items()})


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- the multinomial pmf and draws -----------------------------------------

@pytest.mark.parametrize("k, N", [(2, 5), (3, 12), (6, 100)])
def test_multinomial_pdf_matches_jax(k, N):
    rng = np.random.default_rng(k * 100 + N)
    p = rng.dirichlet(np.ones(k), size=40).astype(np.float32)
    n = rng.multinomial(N, [1.0 / k] * k, size=40).astype(np.int32)
    want = q.multinomial_pdf(jnp.asarray(n), jnp.asarray(p))
    got = qt.multinomial_pdf(torch.as_tensor(n), torch.as_tensor(p))
    _close(got, want)


@pytest.mark.parametrize("N", [1, 7, 50])
def test_sample_multinomial_totals_and_moments(N):
    p = np.array([0.2, 0.3, 0.5])
    draws = qt.sample_multinomial(_gen(N), N, p, (200_000,)).numpy()
    assert draws.dtype == np.int32 and draws.shape == (200_000, 3)
    assert (draws.sum(-1) == N).all()
    mean = draws.mean(0)
    se = np.sqrt(N * p * (1 - p) / draws.shape[0])
    assert np.all(np.abs(mean - N * p) <= 4 * se)


# -- test models -------------------------------------------------------------

def _test_model_case(name, rng):
    if name == "inversion":
        mps = rng.uniform(0, 1, (30, 1)).astype(np.float32)
        eps = {"t": rng.uniform(0.5, 20, 7).astype(np.float32),
               "w_": rng.uniform(0, 1, 7).astype(np.float32)}
        return q.SimpleInversionModel(), qt.SimpleInversionModel(), mps, \
            eps, np.array([0, 1], np.int32)
    if name == "noisy_coin":
        mps = rng.uniform(0, 1, (30, 1)).astype(np.float32)
        eps = {"alpha": rng.uniform(0.5, 1, 7).astype(np.float32),
               "beta": rng.uniform(0, 0.5, 7).astype(np.float32)}
        return q.NoisyCoinModel(), qt.NoisyCoinModel(), mps, eps, \
            np.array([0, 1], np.int32)
    mps = rng.dirichlet(np.ones(6), 30).astype(np.float32)
    eps = {"exp_num": np.arange(7, dtype=np.int32)}
    return q.NDieModel(6), qt.NDieModel(6), mps, eps, \
        np.array([0, 3, 5, 2], np.int32)


@pytest.mark.parametrize("name", ["inversion", "noisy_coin", "die"])
def test_item8_test_models_likelihood_matches_jax(name):
    rng = np.random.default_rng(len(name))
    jm, tm, mps, eps, outs = _test_model_case(name, rng)
    je, te = _both(eps)
    want = jm.likelihood(jnp.asarray(outs), jnp.asarray(mps), je)
    got = tm.likelihood(torch.as_tensor(outs), torch.as_tensor(mps), te)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    # validity and canonical form agree too
    bad = mps.copy()
    bad[::3] *= 1.5
    np.testing.assert_array_equal(
        np.asarray(tm.are_models_valid(torch.as_tensor(bad))),
        np.asarray(jm.are_models_valid(jnp.asarray(bad))))
    _close(tm.canonicalize(torch.as_tensor(bad)),
           jm.canonicalize(jnp.asarray(bad)))


# -- derived models -----------------------------------------------------------

@pytest.mark.parametrize("k, n_meas_max", [(3, 4), (4, 6)])
def test_multinomial_model_grid_mask_and_likelihood_match_jax(k, n_meas_max):
    rng = np.random.default_rng(k)
    jm = q.MultinomialModel(q.NDieModel(k), n_meas_max=n_meas_max)
    tm = qt.MultinomialModel(qt.NDieModel(k), n_meas_max=n_meas_max)
    assert tm.n_outcomes() == jm.n_outcomes() == math.comb(n_meas_max + k, k)
    np.testing.assert_array_equal(tm.outcomes().numpy(),
                                  np.asarray(jm.outcomes()))
    eps = {"exp_num": np.zeros(3, np.int32),
           "n_meas": np.array([n_meas_max, 2, 0], np.int32)}
    je, te = _both(eps)
    np.testing.assert_array_equal(tm.outcome_mask(te).numpy(),
                                  np.asarray(jm.outcome_mask(je)))
    mps = rng.dirichlet(np.ones(k), 20).astype(np.float32)
    grid = np.asarray(jm.outcomes())
    want = jm.likelihood(jnp.asarray(grid), jnp.asarray(mps), je)
    got = tm.likelihood(torch.as_tensor(grid), torch.as_tensor(mps), te)
    _close(got, want)
    assert tm.outcome_ndim == jm.outcome_ndim == 1
    dom = tm.domain(te)
    assert [d.n_members for d in dom] == [d.n_members for d in jm.domain(je)]


def test_multinomial_grid_cap_raises_as_in_jax():
    jm = q.MultinomialModel(q.NDieModel(6), n_meas_max=100)
    tm = qt.MultinomialModel(qt.NDieModel(6), n_meas_max=100)
    with pytest.raises(ValueError, match="intractable"):
        jm.outcomes()
    with pytest.raises(ValueError, match="intractable"):
        tm.outcomes()


def test_torch_multinomial_simulation_honours_each_n_meas():
    """Port of ``test_multinomial_simulation_per_experiment_n_meas``:
    each experiment's own ``n_meas`` sets its totals, and the counts
    follow the category probabilities."""
    m = qt.MultinomialModel(qt.NDieModel(3), n_meas_max=16)
    p = torch.tensor([[0.5, 0.3, 0.2]])
    eps = {"exp_num": torch.tensor([0, 1], dtype=torch.int32),
           "n_meas": torch.tensor([12, 5], dtype=torch.int32)}
    draws = m.simulate_experiment(_gen(0), p, eps, repeat=20_000).numpy()
    assert draws.shape == (20_000, 1, 2, 3) and draws.dtype == np.int32
    totals = draws.sum(-1)
    assert np.all(totals[:, 0, 0] == 12) and np.all(totals[:, 0, 1] == 5)
    for e, N in enumerate((12, 5)):
        mean = draws[:, 0, e].mean(0)
        se = np.sqrt(N * p[0].numpy() * (1 - p[0].numpy()) / 20_000)
        assert np.all(np.abs(mean - N * p[0].numpy()) <= 4 * se)


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
@pytest.mark.parametrize("under", ["precession", "binomial"])
def test_mle_model_matches_jax(power, under):
    """The annealed likelihood and its log form. Over a binomial of N
    shots an ulp δ of difference in Pr(0) moves log L by up to κ·δ, κ =
    n/p + (N − n)/(1 − p) (ROADMAP queue 3), so that case is held per
    entry at power·(1e-5·|log L| + 4·2⁻²⁴·κ) in log space, and the linear
    likelihood at the same relative tolerance."""
    rng = np.random.default_rng(int(power * 10))
    mps = rng.uniform(0, 1, (25, 1)).astype(np.float32)
    t = rng.uniform(0.5, 30, 5).astype(np.float32)
    if under == "precession":
        jm = q.MLEModel(q.SimplePrecessionModel(), power)
        tm = qt.MLEModel(qt.SimplePrecessionModel(), power)
        eps = {"t": t}
        outs = np.array([0, 1], np.int32)
    else:
        jm = q.MLEModel(q.BinomialModel(q.SimplePrecessionModel(), 40),
                        power)
        tm = qt.MLEModel(qt.BinomialModel(qt.SimplePrecessionModel(), 40),
                         power)
        eps = {"t": t, "n_meas": np.full(5, 40, np.int32)}
        outs = np.array([0, 3, 20, 40], np.int32)
    je, te = _both(eps)
    args_j = (jnp.asarray(outs), jnp.asarray(mps), je)
    args_t = (torch.as_tensor(outs), torch.as_tensor(mps), te)
    log_want = np.asarray(jm.log_likelihood(*args_j), np.float64)
    log_got = tm.log_likelihood(*args_t).numpy().astype(np.float64)
    tol = power * 1e-5 * np.abs(log_want)
    if under == "binomial":
        p = np.cos(mps[None, :, :].astype(np.float64)
                   * t[None, None, :] / 2) ** 2
        n = outs[:, None, None].astype(np.float64)
        kappa = n / np.maximum(p, 1e-30) + (40 - n) / np.maximum(1 - p,
                                                                  1e-30)
        tol = tol + power * 4 * 2.0 ** -24 * kappa
    assert np.all(np.abs(log_got - log_want) <= tol + 1e-4)
    want = np.asarray(jm.likelihood(*args_j), np.float64)
    got = tm.likelihood(*args_t).numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= want * (np.expm1(tol) + RTOL) + ATOL)
    assert tm.has_log_likelihood == jm.has_log_likelihood


@pytest.mark.parametrize("count", [0, 5, 40, 300])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_referenced_poisson_log_likelihood_matches_jax(count, mode):
    rng = np.random.default_rng(count + mode)
    jm = q.ReferencedPoissonModel(q.SimplePrecessionModel(), max_count=512)
    tm = qt.ReferencedPoissonModel(qt.SimplePrecessionModel(), max_count=512)
    mps = np.stack([rng.uniform(0, 1, 30), rng.uniform(20, 60, 30),
                    rng.uniform(0, 5, 30)], 1).astype(np.float32)
    eps = {"t": rng.uniform(1, 7, 4).astype(np.float32),
           "mode": np.full(4, mode, np.int32)}
    je, te = _both(eps)
    outs = np.array([count], np.int32)
    want = jm.log_likelihood(jnp.asarray(outs), jnp.asarray(mps), je)
    got = tm.log_likelihood(torch.as_tensor(outs), torch.as_tensor(mps), te)
    _close(got, want, rtol=RTOL, atol=2e-4)
    np.testing.assert_array_equal(
        tm.are_models_valid(torch.as_tensor(mps)).numpy(),
        np.asarray(jm.are_models_valid(jnp.asarray(mps))))


def test_referenced_poisson_draws_have_the_rate_as_mean():
    m = qt.ReferencedPoissonModel(qt.SimplePrecessionModel(), max_count=512)
    mps = torch.tensor([[0.5, 40.0, 2.0]])
    eps = {"t": torch.tensor([2.0, 2.0, 2.0]),
           "mode": torch.tensor([0, 1, 2], dtype=torch.int32)}
    sims = m.simulate_experiment(_gen(1), mps, eps, repeat=200_000).numpy()
    p0 = math.cos(0.5) ** 2
    rates = np.array([p0 * 40 + (1 - p0) * 2, 40.0, 2.0])
    mean = sims[:, 0, :].mean(0)
    assert np.all(np.abs(mean - rates) <= 4 * np.sqrt(rates / 200_000))


@pytest.mark.parametrize("diagonal", [True, False])
def test_learned_walk_step_matches_jax_given_the_normals(diagonal):
    """The learned walk's step from the same standard normals: the JAX
    model's ``update_timestep`` draws z = ``normal(key, (n, d, n_e))``;
    the port's ``learned_step`` takes that z. Also the names, Q, and the
    carry-over of the walk by ``convert``."""
    rng = np.random.default_rng(int(diagonal))
    jm = q.GaussianRandomWalkModel(q.MultiCosineModel(2), scale=0.01,
                                   diagonal=diagonal, model_mu_sigma=True)
    tm = convert.gaussian_random_walk_from_numpy(
        qt.MultiCosineModel(2), np.asarray(jm.step_distribution.cov),
        diagonal, True)
    assert tm.n_modelparams == jm.n_modelparams
    assert tm.modelparam_names == jm.modelparam_names
    np.testing.assert_array_equal(tm.Q.numpy(), np.asarray(jm.Q))
    n_e, n = 3, 40
    mps = np.concatenate([rng.uniform(0, 1, (n, 2)),
                          rng.uniform(-5, -2, (n, jm.n_modelparams - 2))],
                         1).astype(np.float32)
    eps = {"t": np.ones(n_e, np.float32)}
    key = jax.random.key(3)
    want = jm.update_timestep(key, jnp.asarray(mps),
                              {"t": jnp.asarray(eps["t"])})
    z = np.asarray(jax.random.normal(key, (n, 2, n_e)))
    got = tm.learned_step(torch.as_tensor(mps), torch.as_tensor(z))
    _close(got, want)


def test_fixed_walks_carry_over_and_step_with_their_covariance():
    cov = np.array([[4e-4, 1e-4], [1e-4, 1e-4]])
    jm = q.GaussianRandomWalkModel(q.MultiCosineModel(2), scale=cov,
                                   diagonal=False)
    tm = convert.gaussian_random_walk_from_numpy(
        qt.MultiCosineModel(2), np.asarray(jm.step_distribution.cov), False,
        False)
    _close(tm.step_distribution.cov, jm.step_distribution.cov)
    x = torch.zeros((100_000, 2))
    steps = tm.update_timestep(_gen(2), x, {"t": torch.ones(1)})[:, :, 0]
    emp = np.cov(steps.numpy().T)
    np.testing.assert_allclose(emp, cov, rtol=0.03, atol=3e-6)
    rw = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                            qt.NormalDistribution(0.0, 0.01 ** 2))
    assert rw.is_time_dependent and not qt.SimplePrecessionModel() \
        .is_time_dependent
    out = rw.update_timestep(_gen(3), torch.full((50_000, 1), 0.5),
                             {"t": torch.ones(2)})
    assert out.shape == (50_000, 1, 2)
    assert abs(float(out.std()) - 0.01) <= 4 * 0.01 / math.sqrt(2 * 50_000)


# -- domains, simplex transforms, host helpers ------------------------------

@pytest.mark.parametrize("n, k", [(3, 2), (4, 3), (5, 4)])
def test_multinomial_domain_matches_jax(n, k):
    jd, td = q.MultinomialDomain(n, k), qt.MultinomialDomain(n, k)
    assert td.n_members == jd.n_members
    np.testing.assert_array_equal(td.values, jd.values)
    np.testing.assert_array_equal(td.example_point, jd.example_point)
    pts = np.concatenate([jd.values, jd.values[:2] + 1,
                          -jd.values[:1]]).astype(np.int32)
    np.testing.assert_array_equal(
        td.in_domain(torch.as_tensor(pts)).numpy(),
        np.asarray(jd.in_domain(jnp.asarray(pts))))


def test_simplex_transforms_and_helpers_match_jax():
    rng = np.random.default_rng(9)
    y = rng.uniform(0.05, 0.95, (20, 4)).astype(np.float32)
    p = q.utils.to_simplex(jnp.asarray(y))
    _close(qt.to_simplex(torch.as_tensor(y)), p)
    _close(qt.from_simplex(torch.as_tensor(np.asarray(p))),
           q.utils.from_simplex(p), rtol=1e-5, atol=1e-6)
    x = rng.normal(size=5).astype(np.float32)
    _close(qt.outer_product(torch.as_tensor(x)),
           q.utils.outer_product(jnp.asarray(x)))
    assert qt.uniquify([3, 1, 3, 2, 1]) == q.utils.uniquify([3, 1, 3, 2, 1])
    for v, u in ((0.12345, 0.002), (12345.0, 30.0), (1.5, 0.0)):
        assert (qt.format_uncertainty(v, u)
                == q.utils.format_uncertainty(v, u))
    np.testing.assert_array_equal(qt.compactspace(2.0, 7),
                                  q.utils.compactspace(2.0, 7))
    assert qt.safe_shape(np.zeros((3, 4)), 1) == 4
    assert qt.safe_shape(np.float32(1.0)) == q.utils.safe_shape(1.0) == 1
    a = np.zeros(3, dtype=[("t", "f4")])
    b = np.ones(3, dtype=[("n", "i4")])
    joined = qt.join_struct_arrays([a, b])
    assert joined.dtype == q.utils.join_struct_arrays([a, b]).dtype
    qt.assert_sigfigs_equal(1.2344, 1.2341, sigfigs=3)
    with pytest.raises(AssertionError):
        qt.assert_sigfigs_equal(1.25, 1.35, sigfigs=3)


# -- heuristics ----------------------------------------------------------------

@pytest.mark.parametrize("idx", [0, 7, 127, 128, 400, 10_000])
@pytest.mark.parametrize("base", [2.0, 1.02])
def test_exp_sparse_times_match_jax_and_cap_at_e60(idx, base):
    """t_k = scale·base^k in float32 log space, capped at e^60: finite at
    k ≥ 128 for base 2, where base^k overflows float32."""
    ju = q.SMCUpdater(q.SimplePrecessionModel(), 10,
                      q.UniformDistribution([[0, 1]]))
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 10,
                       qt.UniformDistribution([[0, 1]]), device="cpu")
    want = float(q.ExpSparseHeuristic(ju, scale=0.5, base=base)(idx)["t"][0])
    got = qt.ExpSparseHeuristic(tu, scale=0.5, base=base)(idx)["t"]
    assert got.dtype == torch.float32 and got.shape == (1,)
    assert math.isfinite(float(got[0])) and float(got[0]) <= math.exp(60) * (
        1 + 1e-6)
    np.testing.assert_allclose(float(got[0]), want, rtol=2e-6)


def test_identity_heuristic_and_exp_sparse_fields():
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 10,
                       qt.UniformDistribution([[0, 1]]), device="cpu")
    h = qt.IdentityHeuristic(tu, {"t": np.array([2.5]), "n_meas": 7})
    e = h(3)
    assert e["t"].dtype == torch.float32 and float(e["t"][0]) == 2.5
    assert e["n_meas"].dtype == torch.int32 and int(e["n_meas"][0]) == 7
    assert h(4) is e
    es = qt.ExpSparseHeuristic(tu, other_fields={"n_meas": 40})(2)
    assert float(es["t"][0]) == 4.0 and int(es["n_meas"][0]) == 40


# -- the forwarded engine flags ------------------------------------------------

def _wrapped(pkg):
    sp = pkg.SimplePrecessionModel()
    ale = pkg.ALEApproximateModel(sp, error_tol=0.1)
    return {
        "binomial": pkg.BinomialModel(sp),
        "multinomial": pkg.MultinomialModel(pkg.NDieModel(3)),
        "walk_over_multinomial": pkg.RandomWalkModel(
            pkg.MultinomialModel(pkg.NDieModel(3)),
            pkg.NormalDistribution(0, 1e-4)),
        "poisoned": pkg.PoisonedModel(sp, tol=0.01),
        "walk_over_poisoned": pkg.RandomWalkModel(
            pkg.PoisonedModel(sp, tol=0.01), pkg.NormalDistribution(0, 1e-4)),
        "mle_over_poisoned": pkg.MLEModel(pkg.PoisonedModel(sp, tol=0.01)),
        "walk_over_ale": pkg.RandomWalkModel(
            ale, pkg.NormalDistribution(0, 1e-4)),
        "learned_walk_over_ale": pkg.GaussianRandomWalkModel(
            ale, model_mu_sigma=True),
        "poisson": pkg.ReferencedPoissonModel(sp),
    }


@pytest.mark.parametrize("name", list(_wrapped(qt)))
def test_derived_models_forward_the_engine_flags_as_jax(name):
    jm, tm = _wrapped(q)[name], _wrapped(qt)[name]
    for flag in ("outcome_ndim", "wants_likelihood_key",
                 "has_log_likelihood", "is_time_dependent"):
        assert bool(getattr(tm, flag, False)) == bool(
            getattr(jm, flag, False)), flag
