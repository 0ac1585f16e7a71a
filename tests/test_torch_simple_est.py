"""The port's one-line estimators, ``PostselectedDistribution``,
``perf_test_multiple`` and ``models_bench`` against the JAX package.

The stochastic entry points run both packages on the same data record
(NumPy, from a seed) and compare what both must reach: posterior means
within 0.5 posterior standard deviations of each other and within 5 of
the truth. ``simple_est_*`` run at their default particle counts (6000,
8000): there the RB posterior mean's spread over seeds is at most 0.14
sd in either package, against 0.2-0.38 sd at 2000 particles (too close
to the 0.5 bar for two independent runs). Interleaved RB (four
correlated parameters, no moves) spreads 0.20-0.45 sd over seeds in
either package even at 8000, so its two runs are held within 1 sd.
Deterministic parts compare exactly: ``models_bench``'s record against the JAX benchmark's
recipe, a ``perf_test_multiple`` trial against ``perf_test`` at its seed.
"""

import io
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
import qinfer_tpu_torch as qt
from qinfer_tpu_torch import models_bench

N = 2000


def _close_in_sd(mean_t, cov_t, mean_j, truth, within=0.5):
    sd = np.sqrt(np.diag(np.asarray(cov_t, np.float64)))
    mean_t = np.asarray(mean_t, np.float64)
    assert np.all(np.abs(mean_t - np.asarray(mean_j)) < within * sd), (
        mean_t, mean_j, sd)
    assert np.all(np.abs(mean_t - truth) < 5 * sd), (mean_t, truth, sd)


def _prec_data():
    rng = np.random.default_rng(3)
    ts = np.asarray([(9 / 8) ** k / 5 for k in range(40)])
    counts = rng.binomial(20, np.cos(0.43 * ts / 2) ** 2)
    return np.stack([counts, ts, np.full(40, 20)], axis=1)


def _rb_data(interleaved=False):
    rng = np.random.default_rng(4)
    ms = np.tile([1, 2, 4, 8, 16, 32, 64, 128], 4)
    ref = (np.arange(len(ms)) % 2).astype(float)
    p = np.where(ref > 0, 0.97, 0.93) if interleaved else 0.95
    counts = rng.binomial(30, 0.4 * p ** ms + 0.5)
    cols = [counts, ms, np.full(len(ms), 30)] + ([ref] if interleaved else [])
    return np.stack(cols, axis=1).astype(float)


def test_simple_est_prec_matches_jax():
    data = _prec_data()
    mean, cov, extra = qt.simple_est_prec(data, return_all=True,
                                          device="cpu")
    mean_j, _ = q.simple_est_prec(data)
    assert mean.shape == (1,) and cov.shape == (1, 1)
    assert isinstance(extra["updater"], qt.SMCUpdater)
    assert len(extra["updater"].data_record) == 40
    _close_in_sd(mean, cov, mean_j, [0.43])


@pytest.mark.parametrize("interleaved", [False, True])
def test_simple_est_rb_matches_jax(interleaved):
    data = _rb_data(interleaved)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mean, cov = qt.simple_est_rb(data, interleaved=interleaved,
                                     device="cpu")
        mean_j, _ = q.simple_est_rb(data, interleaved=interleaved)
    truth = [0.93, 0.97, 0.4, 0.5] if interleaved else [0.95, 0.4, 0.5]
    assert mean.shape == (len(truth),)
    _close_in_sd(mean, cov, mean_j, truth, within=1.0 if interleaved
                 else 0.5)
    if interleaved:
        # the reference sequences decay with p_ref, the others with p̃
        assert mean[1] > mean[0] and mean_j[1] > mean_j[0]


def test_load_data_reads_every_form(tmp_path):
    data = _prec_data()
    path = tmp_path / "d.csv"
    np.savetxt(path, data, delimiter=",")
    buf = io.StringIO()
    np.savetxt(buf, data, delimiter=",")
    buf.seek(0)
    forms = [data, data.tolist(), str(path), buf]
    try:
        import pandas as pd

        forms.append(pd.DataFrame(data))
    except ImportError:
        pass
    for form in forms:
        np.testing.assert_allclose(qt.load_data(form), data)
    with pytest.raises(ValueError):
        qt.load_data(data[:, :2])
    with pytest.raises(ValueError):
        qt.simple_est_prec(data[:, :2], device="cpu")


def test_postselected_distribution_matches_jax():
    rb_t, rb_j = qt.RandomizedBenchmarkingModel(), \
        q.RandomizedBenchmarkingModel()
    box = [[0.0, 1.0], [0.0, 1.0], [0.0, 1.0]]
    d = qt.PostselectedDistribution(qt.UniformDistribution(box), rb_t)
    x = d.sample(torch.Generator().manual_seed(1), 5000)
    assert x.shape == (5000, 3) and bool(rb_t.are_models_valid(x).all())
    assert d.n_rvs == 3
    # log_pdf: the base density inside the validity region, -inf outside
    pts = np.asarray([[0.9, 0.4, 0.5], [0.9, 0.6, 0.5], [0.5, 0.1, 0.1]],
                     np.float32)
    jd = q.PostselectedDistribution(q.UniformDistribution(box), rb_j)
    np.testing.assert_array_equal(d.log_pdf(torch.as_tensor(pts)).numpy(),
                                  np.asarray(jd.log_pdf(jnp.asarray(pts))))
    # a validity region the base never reaches: both raise
    empty = [[0.0, 1.0], [0.9, 1.0], [0.9, 1.0]]
    with pytest.raises(RuntimeError, match="maxiters"):
        qt.PostselectedDistribution(qt.UniformDistribution(empty), rb_t,
                                    maxiters=3).sample(
            torch.Generator().manual_seed(0), 50)
    with pytest.raises(RuntimeError, match="maxiters"):
        q.PostselectedDistribution(q.UniformDistribution(empty), rb_j,
                                   maxiters=3).sample(jax.random.key(0), 50)


def test_perf_test_multiple_with_an_injected_apply():
    """Trial i is perf_test at seed + 1000·i; ``apply`` may return a handle
    with ``get()``; the progress bar sees start, every update and the
    finish."""
    calls, events = [], []

    class Handle:
        def __init__(self, value):
            self.value = value

        def get(self):
            return self.value

    def apply(fn, i):
        calls.append(i)
        return Handle(fn(i))

    class Bar:
        def start(self, max):
            events.append(("start", max))

        def update(self, i):
            events.append(("update", i))

        def finished(self):
            events.append(("finished",))

    args = (qt.SimplePrecessionModel(), 300,
            qt.UniformDistribution([[0.0, 1.0]]), 12)
    res = qt.perf_test_multiple(3, *args, apply=apply, progressbar=Bar,
                                seed=5, device="cpu", true_mps=[[0.6]])
    assert calls == [0, 1, 2]
    assert events == [("start", 3), ("update", 1), ("update", 2),
                      ("update", 3), ("finished",)]
    assert res.shape == (3, 12) and res.dtype.names == (
        "elapsed_time", "loss", "resample_count", "outcome")
    serial = qt.perf_test_multiple(3, *args, seed=5, device="cpu",
                                   true_mps=[[0.6]])
    for i in range(3):
        perf, _ = qt.perf_test(*args, seed=5 + 1000 * i, device="cpu",
                               true_mps=[[0.6]])
        for field in ("loss", "resample_count", "outcome"):
            np.testing.assert_array_equal(res[i][field], perf[field])
            np.testing.assert_array_equal(serial[i][field], perf[field])


def test_models_bench_matches_the_jax_config_on_the_same_record():
    """At 2000 particles and one repeat: the record is the JAX benchmark's
    (its recipe rebuilt here, config 2's draws first), and the posteriors
    of both packages on it agree."""
    rng = np.random.default_rng(0)
    ladder = np.minimum(np.asarray([1.2 ** k for k in range(32)]), 30.0)
    ts = ladder.astype(np.float32)
    true2 = np.array([0.71, 0.08])  # float64 arrays, as the JAX bench's
    vis = np.exp(-true2[1] * ts)
    counts2 = rng.binomial(20, vis * np.cos(true2[0] * ts / 2) ** 2
                           + (1 - vis) / 2)
    ms = np.unique(np.round(1.6 ** np.arange(1, 17))).astype(np.float32)
    true3 = np.array([0.95, 0.5, 0.5])
    counts3 = rng.binomial(25, np.clip(true3[1] * true3[0] ** ms + true3[2],
                                       0.0, 1.0))
    c2, c3 = models_bench.make_configs(1)
    np.testing.assert_array_equal(c2.eps["t"], ts)
    np.testing.assert_array_equal(c2.counts, counts2)
    np.testing.assert_array_equal(c3.eps["m"], ms)
    np.testing.assert_array_equal(c3.counts, counts3)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (u2, r2), (u3, r3) = models_bench.run_bench(N, 1, "cpu")
        jax_models = (
            (q.BinomialModel(q.RamseyModel(), n_meas_max=20),
             q.UniformDistribution([[0.0, 1.0], [0.0, 0.5]])),
            (q.BinomialModel(q.RandomizedBenchmarkingModel(),
                             n_meas_max=25),
             q.UniformDistribution([[0.8, 1.0], [0.3, 0.7], [0.3, 0.7]])))
        for cfg, u, rec, (jm, jprior) in zip((c2, c3), (u2, u3), (r2, r3),
                                             jax_models):
            ju = q.SMCUpdater(jm, N, jprior, seed=7)
            ju.batch_update(jnp.asarray(cfg.counts),
                            {k: jnp.asarray(v) for k, v in cfg.eps.items()})
            _close_in_sd(u.est_mean().numpy(),
                         u.est_covariance_mtx().numpy(),
                         np.asarray(ju.est_mean()), cfg.true)
            assert rec["n_experiments"] == len(cfg.counts)
            assert rec["n_particles"] == N
            assert rec["resamples"] == u.resample_count >= 1
            assert rec["value"] == N * len(cfg.counts) / rec["wall_s"]
            assert 0 <= rec["max_z_vs_true"] < 5
            assert list(rec["est"]) == cfg.names
    region = r3["region_est"]
    assert 0 < region["credible_points"] <= N
    assert len(region["mvee_center"]) == 3
    assert np.all(np.isfinite(region["mvee_center"]))
    assert "region_est" not in r2


def test_entry_points_refuse_to_leave_the_card():
    """Without a CUDA device the defaults raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    prior = qt.UniformDistribution([[0.0, 1.0], [0.0, 0.5]])
    calls = [
        lambda: qt.SMCUpdaterBCRB(qt.RamseyModel(), 10, prior),
        lambda: qt.simple_est_prec(_prec_data()),
        lambda: qt.simple_est_rb(_rb_data()),
        lambda: qt.perf_test_multiple(1, qt.SimplePrecessionModel(), 10,
                                      qt.UniformDistribution([[0.0, 1.0]]),
                                      2),
        lambda: models_bench.run_bench(10, 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert models_bench.main(["--particles", "10", "--repeats", "1"]) == 1
