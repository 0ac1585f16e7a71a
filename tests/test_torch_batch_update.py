"""The port's ``SMCUpdater.batch_update`` and ``resample()`` against their
contracts and the JAX package.

* ``batch_update`` equals the loop ``update(o_i, e_i,
  check_for_resample=(i % k == k − 1))`` to the bit, with and without
  moves, compressed or full record, adaptive or waste-free.
* Without resampling (``resample_interval=0``: never check) it matches
  the JAX package on one carried ensemble: weights to rtol 1e-4 of their
  max and the step normalizations and evidence to rtol 1e-4 (float32
  log-binomial reweights of 20-25 shots: a count multiplies an ulp of
  Pr(0) by up to n/p + (N − n)/(1 − p), over 32-64 steps).
* With resampling, on BASELINE configs 2 (Ramsey) and 3 (RB) at 4000
  particles and 64 / 32 experiments, the posterior means of the two
  packages lie within 0.5 posterior standard deviations of each other,
  and both within 4 combined Monte-Carlo errors of the independent
  float64 oracle ``tests/test_crosscheck_numpy.py::numpy_smc`` (3 seeds;
  the error floored at 0.1 posterior sd, as that file's own check).
* A zero-weight step under ``'error'`` leaves the same committed prefix
  as the JAX package's replay: the record's length exactly, weights to
  1e-5 of their max (the precession reweights of ``test_torch_smc.py``)
  and the step normalizations to rtol 1e-5.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import binom

import qinfer_tpu as q
import qinfer_tpu_torch as qt
from qinfer_tpu_torch.convert import state_from_numpy
from qinfer_tpu_torch.models_bench import make_configs

from test_crosscheck_numpy import numpy_smc


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if f != "key"}


def _jax_pair(tag):
    """(JAX model, prior) of a models_bench config."""
    if tag == "ramsey_t2":
        return (q.BinomialModel(q.RamseyModel(), n_meas_max=20),
                q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]))
    return (q.BinomialModel(q.RandomizedBenchmarkingModel(), n_meas_max=25),
            q.UniformDistribution([[0.8, 1.0], [0.3, 0.7], [0.3, 0.7]]))


def _configs(repeats=1):
    return {c.tag: c for c in make_configs(repeats)}


_OPTIONS = {
    "plain": {},
    "moves_full": {"n_mcmc_moves": 2},
    "moves_compressed": {"n_mcmc_moves": 2, "compress_mcmc_record": True},
    "moves_adaptive": {"n_mcmc_moves": 2, "compress_mcmc_record": True,
                       "mcmc_adapt": True},
    "waste_free": {"n_mcmc_moves": 0, "compress_mcmc_record": True,
                   "waste_free_stages": 4, "zero_weight_policy": "reset"},
}


@pytest.mark.parametrize("tag", ["ramsey_t2", "rb"])
@pytest.mark.parametrize("opts", sorted(_OPTIONS))
def test_batch_update_is_the_update_loop_to_the_bit(tag, opts):
    cfg = _configs()[tag]
    k = 3
    us = [qt.SMCUpdater(cfg.model, 400, cfg.prior, seed=11, device="cpu",
                        **_OPTIONS[opts]) for _ in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", qt.ResamplerWarning)
        calls = cfg.model.call_count
        norms = us[0].batch_update(cfg.counts, cfg.eps, resample_interval=k)
        T = len(cfg.counts)
        assert cfg.model.call_count - calls == T * 400
        for i in range(T):
            us[1].update(int(cfg.counts[i]),
                         {f: v[i:i + 1] for f, v in cfg.eps.items()},
                         check_for_resample=(i % k == k - 1))
    a, b = us
    assert a.resample_count == b.resample_count >= 2
    assert torch.equal(a.particle_weights, b.particle_weights)
    assert torch.equal(a.particle_locations, b.particle_locations)
    assert a.normalization_record == b.normalization_record
    assert norms.dtype == np.float64 and list(norms) == a.normalization_record
    assert a.data_record == [int(c) for c in cfg.counts]
    assert a.log_total_likelihood == b.log_total_likelihood
    assert a.mcmc_acceptance_record == b.mcmc_acceptance_record
    if _OPTIONS[opts].get("n_mcmc_moves", 0):
        # the JAX package's batch_update leaves this empty; the port fills
        # it on every move call, as update does
        assert len(a.mcmc_acceptance_record) == a.resample_count
        assert all(0.0 <= x <= 1.0 for x in a.mcmc_acceptance_record)


def test_interval_gate_and_zero_interval_match_jax():
    """With the ESS always low (resample_thresh=1), the resample fires
    exactly on the steps i % k == k − 1, and never for k <= 0, in both
    packages."""
    ts = np.linspace(0.5, 5.0, 10).astype(np.float32)
    outs = (np.arange(10) % 2).astype(np.int32)
    for k, want in ((3, 3), (1, 10), (4, 2), (0, 0), (-2, 0)):
        ju = q.SMCUpdater(q.SimplePrecessionModel(), 200,
                          q.UniformDistribution([[0.0, 1.0]]), seed=1,
                          resample_thresh=1.0)
        ju.batch_update(jnp.asarray(outs), {"t": jnp.asarray(ts)},
                        resample_interval=k)
        tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 200,
                           qt.UniformDistribution([[0.0, 1.0]]), seed=1,
                           resample_thresh=1.0, device="cpu")
        tu.batch_update(outs, {"t": ts}, resample_interval=k)
        assert ju.resample_count == tu.resample_count == want, k
        assert len(tu.data_record) == len(tu.normalization_record) == 10


@pytest.mark.parametrize("tag", ["ramsey_t2", "rb"])
def test_batch_update_without_resampling_matches_jax(tag):
    cfg = _configs(repeats=2)[tag]
    jm, jprior = _jax_pair(tag)
    ju = q.SMCUpdater(jm, 3000, jprior, seed=4)
    tu = qt.SMCUpdater(cfg.model, 3000, cfg.prior, device="cpu")
    tu.state = state_from_numpy(_jax_arrays(ju.state), "cpu")
    jn = np.asarray(ju.batch_update(
        jnp.asarray(cfg.counts), {k: jnp.asarray(v) for k, v in
                                  cfg.eps.items()}, resample_interval=0))
    tn = tu.batch_update(cfg.counts, cfg.eps, resample_interval=0)
    assert ju.resample_count == tu.resample_count == 0
    jw = np.asarray(ju.particle_weights)
    np.testing.assert_allclose(tu.particle_weights.numpy(), jw, rtol=0,
                               atol=1e-4 * jw.max())
    np.testing.assert_allclose(tn, jn, rtol=1e-4)
    np.testing.assert_allclose(tu.log_total_likelihood,
                               ju.log_total_likelihood, rtol=1e-4)
    assert len(tu.data_record) == len(ju.data_record) == len(cfg.counts)


def _oracle(cfg):
    """numpy_smc's likelihood, prior sampler and validity for a config."""
    n_shots = int(cfg.eps["n_meas"][0])
    lo, hi = (np.asarray(cfg.prior.ranges[:, i]) for i in (0, 1))
    if cfg.tag == "ramsey_t2":
        def like(o, x, t):
            vis = np.exp(-x[:, 1] * t)
            p0 = vis * np.cos(x[:, 0] * t / 2) ** 2 + (1 - vis) / 2
            return binom.pmf(o, n_shots, p0)

        def valid(x):
            return (x[:, 0] >= 0) & (x[:, 1] >= 0)
        eps = cfg.eps["t"]
    else:
        def like(o, x, m):
            p0 = np.clip(x[:, 1] * x[:, 0] ** m + x[:, 2], 0.0, 1.0)
            return binom.pmf(o, n_shots, p0)

        def valid(x):
            return ((x[:, 0] >= 0) & (x[:, 0] <= 1) & (x[:, 1] >= 0)
                    & (x[:, 2] >= 0) & (x[:, 1] + x[:, 2] <= 1))
        eps = cfg.eps["m"]
    return like, (lambda rng, n: rng.uniform(lo, hi, (n, len(lo)))), valid, \
        [float(e) for e in eps]


@pytest.mark.parametrize("tag", ["ramsey_t2", "rb"])
def test_resampled_posterior_agrees_with_jax_and_the_f64_oracle(tag):
    cfg = _configs(repeats=2)[tag]
    n = 4000
    jm, jprior = _jax_pair(tag)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ju = q.SMCUpdater(jm, n, jprior, seed=7)
        ju.batch_update(jnp.asarray(cfg.counts),
                        {k: jnp.asarray(v) for k, v in cfg.eps.items()})
        tu = qt.SMCUpdater(cfg.model, n, cfg.prior, seed=7, device="cpu")
        tu.batch_update(cfg.counts, cfg.eps)
    assert tu.resample_count >= 2 and ju.resample_count >= 2
    mu_t = tu.est_mean().numpy().astype(np.float64)
    mu_j = np.asarray(ju.est_mean(), np.float64)
    sd = np.sqrt(np.diag(tu.est_covariance_mtx().numpy()).astype(np.float64))
    assert np.all(np.abs(mu_t - mu_j) < 0.5 * sd), (mu_t, mu_j, sd)

    like, prior, valid, eps = _oracle(cfg)
    mus, sds = [], []
    for s in range(3):
        w, x = numpy_smc(like, prior, valid, list(cfg.counts), eps, n,
                         seed=300 + s)
        m = w @ x
        mus.append(m)
        sds.append(np.sqrt(np.diag((w[:, None] * (x - m)).T @ (x - m))))
    mus, sds = np.asarray(mus), np.asarray(sds)
    se = np.maximum(mus.std(axis=0, ddof=1), 0.1 * sds.mean(axis=0))
    for mu in (mu_t, mu_j):
        z = np.abs(mu - mus.mean(axis=0)) / (np.sqrt(2.0) * se)
        assert np.all(z < 4.0), (mu, mus.mean(axis=0), se)


def test_zero_weight_error_leaves_the_jax_prefix():
    """Step 3 (t = 0, outcome 1) is impossible for every particle: both
    packages raise there with steps 0-2 committed."""
    ts = np.asarray([1.0, 2.0, 3.0, 0.0, 4.0], np.float32)
    outs = np.asarray([0, 1, 0, 1, 0], np.int32)
    ju = q.SMCUpdater(q.SimplePrecessionModel(), 1000,
                      q.UniformDistribution([[0.0, 1.0]]), seed=2)
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 1000,
                       qt.UniformDistribution([[0.0, 1.0]]), device="cpu")
    tu.state = state_from_numpy(_jax_arrays(ju.state), "cpu")
    with pytest.raises(q.ZeroWeightError):
        ju.batch_update(jnp.asarray(outs), {"t": jnp.asarray(ts)})
    with pytest.raises(qt.ZeroWeightError):
        tu.batch_update(outs, {"t": ts})
    assert len(tu.data_record) == len(ju.data_record) == 3
    assert len(tu.normalization_record) == len(ju.normalization_record) == 3
    jw = np.asarray(ju.particle_weights)
    np.testing.assert_allclose(tu.particle_weights.numpy(), jw, rtol=0,
                               atol=1e-5 * jw.max())
    np.testing.assert_allclose(tu.normalization_record,
                               ju.normalization_record, rtol=1e-5)


@pytest.mark.parametrize("compress", [False, True])
def test_resample_before_any_update_in_both_packages(compress):
    """The empty-record guard: a manual resample on a fresh updater with
    moves configured resamples and runs no move."""
    opts = dict(n_mcmc_moves=2, compress_mcmc_record=compress)
    ju = q.SMCUpdater(q.BinomialModel(q.RamseyModel(), n_meas_max=4), 300,
                      q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                      seed=0, **opts)
    ju.resample()
    tu = qt.SMCUpdater(qt.BinomialModel(qt.RamseyModel(), n_meas_max=4), 300,
                       qt.UniformDistribution([[0.0, 1.0], [0.0, 0.5]]),
                       device="cpu", **opts)
    tu.resample()
    for u in (ju, tu):
        assert u.resample_count == 1 and u.just_resampled
        assert u.mcmc_acceptance_record == []
    torch.testing.assert_close(tu.particle_weights,
                               torch.full((300,), 1.0 / 300))


class _CountingMultiCosine(qt.MultiCosineModel):
    canonicalized = 0

    def canonicalize(self, modelparams):
        self.canonicalized += 1
        return super().canonicalize(modelparams)


@pytest.mark.parametrize("case", ["fresh", "moves_project",
                                  "moves_do_not_project", "no_moves"])
def test_resample_keeps_the_projection_invariant(case):
    """Exactly one strict projection per manual resample: the resampler's,
    the moves', or resample()'s own where neither will project; the
    frequencies come out sorted in both packages. The prior draw is left
    unsorted (canonicalize=False)."""
    opts = {"fresh": dict(n_mcmc_moves=1),
            "moves_project": dict(n_mcmc_moves=1),
            "moves_do_not_project": dict(n_mcmc_moves=1,
                                         mcmc_canonicalize=False),
            "no_moves": dict()}[case]
    prior = [[0.0, 1.0], [0.0, 1.0]]
    t_opts = dict(opts)
    j_opts = dict(opts)
    if case == "moves_do_not_project":
        t_opts["resampler"] = qt.LiuWestResampler(canonicalize=False)
        j_opts["resampler"] = q.LiuWestResampler(canonicalize=False)
    tm = _CountingMultiCosine()
    tu = qt.SMCUpdater(tm, 500, qt.UniformDistribution(prior),
                       canonicalize=False, device="cpu", **t_opts)
    ju = q.SMCUpdater(q.MultiCosineModel(), 500,
                      q.UniformDistribution(prior), canonicalize=False,
                      seed=0, **j_opts)
    x0 = tu.particle_locations
    assert bool((x0[:, 0] > x0[:, 1]).any())
    if case != "fresh":
        tu.update(0, {"t": [2.0]}, check_for_resample=False)
        ju.update(0, {"t": jnp.asarray([2.0])}, check_for_resample=False)
    tm.canonicalized = 0
    tu.resample()
    ju.resample()
    if case != "moves_do_not_project":
        # the last step projected (moves that do not project may unsort
        # what resample() sorted: validity does not ask for the order)
        for x in (tu.particle_locations.numpy(),
                  np.asarray(ju.particle_locations)):
            assert np.all(x[:, 0] <= x[:, 1])
    # one projection each: the moves' ("moves_project"), the resampler's
    # ("no_moves"), else resample()'s own
    assert tm.canonicalized == 1
    assert tu.resample_count == ju.resample_count == 1
    expect_moves = 1 if case in ("moves_project",
                                 "moves_do_not_project") else 0
    assert len(tu.mcmc_acceptance_record) == expect_moves


def test_engine_call_counts_match_jax():
    """One likelihood evaluation per (particle, experiment) for updates
    and batches, whatever the eager calls inside bump themselves."""
    ju = q.SMCUpdater(q.SimplePrecessionModel(), 100,
                      q.UniformDistribution([[0.0, 1.0]]), seed=0)
    tu = qt.SMCUpdater(qt.SimplePrecessionModel(), 100,
                       qt.UniformDistribution([[0.0, 1.0]]), device="cpu")
    for u, arr in ((ju, jnp.asarray), (tu, torch.as_tensor)):
        assert u.model.call_count == 0
        u.update(1, {"t": arr([1.0])})
        assert u.model.call_count == 100
        u.batch_update(arr([0, 1]), {"t": arr([1.0, 2.0])})
        assert u.model.call_count == 300
        u.bayes_risk({"t": arr([1.0, 2.0, 3.0])})
        assert u.model.call_count == 300 + 2 * 100 * 3
