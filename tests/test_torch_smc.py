"""Parity of the port's SMC engine, heuristic and host loop against the JAX
package.

The deterministic reweighting steps start from ONE JAX ensemble carried
across with ``convert.state_from_numpy`` and take the same outcomes and
experiments in both packages. Stochastic paths (PGH, outcome simulation,
resampling) draw from different random streams, so they are compared by
what both must reach.

Tolerances: weights to rtol 1e-5 of their max and the evidence to rtol
1e-5 after 20 steps (float32 order of the reductions: XLA's against
torch's; each step's normalization carries ~1e-7 of relative error); ESS
to rtol 1e-4 (a ratio of two such sums).
"""

import inspect
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu.config import EPS as JAX_EPS
from qinfer_tpu.ops.accelerated import (
    AcceleratedPrecessionModel as JaxAcceleratedPrecessionModel)
from qinfer_tpu.perf_testing import perf_test as jax_perf_test
from qinfer_tpu.smc import (
    SMCState as JaxSMCState,
    _update_step as jax_update_step,
    resample_interval_gate as jax_gate,
)

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.convert import state_from_numpy, state_to_numpy
from qinfer_tpu_torch.heuristics import PGH, categorical_inverse_cdf
from qinfer_tpu_torch.smc import _update_step, resample_interval_gate


class _LogPrecessionTorch(qt.SimplePrecessionModel):
    """Precession with a log-likelihood override: takes the engine's
    max-shifted log path."""

    def log_likelihood(self, outcomes, modelparams, expparams):
        return torch.log(torch.clamp_min(
            self.likelihood(outcomes, modelparams, expparams), qt.EPS))


class _LogPrecessionJax(q.SimplePrecessionModel):
    def log_likelihood(self, outcomes, modelparams, expparams):
        return jnp.log(jnp.clip(
            self.likelihood(outcomes, modelparams, expparams), JAX_EPS,
            None))


_MODELS = {
    "fused": (JaxAcceleratedPrecessionModel, qt.AcceleratedPrecessionModel),
    "log": (_LogPrecessionJax, _LogPrecessionTorch),
    "linear": (q.SimplePrecessionModel, qt.SimplePrecessionModel),
}


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if f != "key"}


@pytest.mark.parametrize("path", sorted(_MODELS))
def test_update_steps_match_jax(path):
    """20 reweight steps (no resampling) through both ``_update_step``s,
    including one step whose outcome is impossible for every particle
    (t = 0, outcome 1) on the linear and fused paths."""
    jax_model, torch_model = (cls() for cls in _MODELS[path])
    n = 4096
    rng = np.random.default_rng(17)
    js = JaxSMCState.initial(
        jnp.asarray(rng.random((n, 1), dtype=np.float32)),
        jax.random.key(0))
    ts = state_from_numpy(_jax_arrays(js), device="cpu")
    jrs, trs = q.LiuWestResampler(), qt.LiuWestResampler()
    gen = torch.Generator().manual_seed(0)
    for k in range(20):
        t = np.float32(0.0 if k == 10 else 1.35 ** k)
        outcome = 1 if k == 10 else int(rng.integers(0, 2))
        js, jlog, jzero = jax_update_step(
            jax_model, jrs, js, jnp.asarray([outcome]),
            {"t": jnp.asarray([t])}, 0.5, 1e-10, check_resample=False)
        ts, tlog, tzero = _update_step(
            torch_model, trs, ts, torch.tensor([outcome]),
            {"t": torch.tensor([t])}, 0.5, 1e-10, gen,
            check_resample=False)
        assert tzero == bool(jzero)
        np.testing.assert_allclose(tlog, float(jlog), rtol=1e-5, atol=1e-6)
    want, got = _jax_arrays(js), state_to_numpy(ts)
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-5 * want["weights"].max())
    np.testing.assert_allclose(got["log_total_likelihood"],
                               want["log_total_likelihood"], rtol=1e-5)
    np.testing.assert_allclose(got["min_n_ess"], want["min_n_ess"],
                               rtol=1e-4)
    assert got["zero_weight_count"] == want["zero_weight_count"]
    assert got["zero_weight_count"] == (0 if path == "log" else 1)
    assert got["resample_count"] == want["resample_count"] == 0
    np.testing.assert_array_equal(got["locations"], want["locations"])


def test_state_round_trip_through_numpy():
    rng = np.random.default_rng(1)
    arrays = _jax_arrays(JaxSMCState.initial(
        jnp.asarray(rng.random((64, 2), dtype=np.float32)),
        jax.random.key(1)))
    back = state_to_numpy(state_from_numpy(arrays, device="cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)


def test_state_from_numpy_defaults_to_the_card():
    """Like every entry point, ``state_from_numpy`` builds on the card
    unless asked for the CPU, and refuses to run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    arrays = _jax_arrays(JaxSMCState.initial(
        jnp.zeros((8, 1), jnp.float32), jax.random.key(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(arrays)


@pytest.mark.parametrize("interval", [0, 1, 5])
def test_resample_interval_gate_matches_jax(interval):
    for idx in range(12):
        got = resample_interval_gate(idx, interval)
        want = jax_gate(idx, interval)
        assert (got is None) == (want is None)
        if want is not None:
            assert bool(got) == bool(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perf_test_recovers_omega_in_both_packages(seed):
    n, steps = 4096, 100
    prior = ([[0.0, 1.0]])
    _, extra = qt.perf_test(qt.AcceleratedPrecessionModel(), n,
                            qt.UniformDistribution(prior), steps,
                            true_mps=[[0.7]], seed=seed, device="cpu")
    _, jextra = jax_perf_test(JaxAcceleratedPrecessionModel(), n,
                              q.UniformDistribution(prior), steps,
                              true_mps=[[0.7]], seed=seed)
    for est in (extra["est"][-1, 0], jextra["est"][-1, 0]):
        assert abs(est - 0.7) < 0.05
    updater = extra["updater"]
    assert updater.resample_count > 0
    assert np.isfinite(updater.log_total_likelihood)
    assert len(updater.normalization_record) == steps


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_zero_weight_error_policy(package):
    """An outcome impossible for every particle (t = 0 gives Pr(1) = 0)
    raises ZeroWeightError before the step is committed."""
    if package == "torch":
        u = qt.SMCUpdater(qt.SimplePrecessionModel(), 50,
                          qt.UniformDistribution([[0.0, 1.0]]),
                          zero_weight_policy="error", seed=0, device="cpu")
        eps, err = {"t": torch.tensor([0.0])}, qt.ZeroWeightError
    else:
        u = q.SMCUpdater(q.SimplePrecessionModel(), 50,
                         q.UniformDistribution([[0.0, 1.0]]),
                         zero_weight_policy="error", seed=0)
        eps, err = {"t": jnp.asarray([0.0])}, q.ZeroWeightError
    before = np.asarray(u.particle_weights).copy()
    with pytest.raises(err):
        u.update(1, eps)
    np.testing.assert_array_equal(np.asarray(u.particle_weights), before)
    assert u.normalization_record == []


def test_zero_weight_warn_and_reset_policies():
    for policy in ("warn", "reset"):
        u = qt.SMCUpdater(qt.SimplePrecessionModel(), 50,
                          qt.UniformDistribution([[0.0, 1.0]]),
                          zero_weight_policy=policy, seed=0, device="cpu")
        u.update(0, {"t": torch.tensor([3.0])})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            u.update(1, {"t": torch.tensor([0.0])})
        assert any(issubclass(c.category, qt.ZeroWeightWarning)
                   for c in caught) == (policy == "warn")
        np.testing.assert_allclose(u.particle_weights.numpy(), 1 / 50)
        assert u.state.zero_weight_count == 1


@pytest.mark.parametrize("entry", ["SMCUpdater", "perf_test"])
def test_entry_points_run_on_the_card_by_default(entry):
    """Without a ``device`` argument the updater and perf_test run on the
    card; on a machine without one they raise and never run on the CPU.
    The updater's default is ``None`` (the card, or the mesh's device when
    it is sharded), perf_test's the card's name."""
    fn = getattr(qt, entry)
    assert inspect.signature(fn).parameters["device"].default == (
        None if entry == "SMCUpdater" else "cuda")
    args = (qt.SimplePrecessionModel(), 16,
            qt.UniformDistribution([[0.0, 1.0]]))

    def run():
        if entry == "SMCUpdater":
            return fn(*args)
        return fn(*args, 2, true_mps=[[0.5]])[1]["updater"]

    if torch.cuda.is_available():
        assert run().state.locations.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()


def test_updater_refuses_options_outside_the_port():
    """Every option of the JAX updater is ported: ``sharding`` takes a
    mesh's particle sharding and refuses anything else; unknown keywords
    raise TypeError; the resampling diagnostics are ported."""
    args = (qt.SimplePrecessionModel(), 10,
            qt.UniformDistribution([[0.0, 1.0]]))
    cpu = {"device": "cpu"}
    jax_params = set(inspect.signature(q.SMCUpdater).parameters)
    assert jax_params <= set(inspect.signature(qt.SMCUpdater).parameters)
    with pytest.raises(TypeError, match="MeshSharding"):
        qt.SMCUpdater(*args, sharding=object(), **cpu)
    with pytest.raises(TypeError):
        qt.SMCUpdater(*args, no_such_option=1, **cpu)
    qt.SMCUpdater(*args, sharding=None, debug_resampling=False,
                  track_resampling_divergence=False, **cpu)  # "off" is fine
    u = qt.SMCUpdater(*args, debug_resampling=True,
                      track_resampling_divergence=True, **cpu)
    assert u.debug_resampling and u.resampling_divergences == []


def test_eig_is_the_one_bench_flag_still_refused():
    """Every flag of the JAX benchmark is ported; ``--eig`` is refused only
    where the JAX benchmark has no candidate pool for it, on the diffusive
    path."""
    from qinfer_tpu_torch import tomography_bench as tb

    assert tb.NOT_PORTED == ()
    args = tb.parse_args("--process --eig --eig-policy auto --eig-epsilon "
                         "0.1 --eig-interval 4".split())
    assert tb.design_from_args(args) == tb.Design("auto", 0.1, 4)
    assert tb.design_from_args(tb.parse_args(["--process"])) is None
    design = tb.design_from_args(tb.parse_args(["--diffusive", "--eig"]))
    with pytest.raises(SystemExit, match="candidate pool"):
        tb.make_config("diffusive", torch.device("cpu"), design=design)
    tb.parse_args("--process --shots 64 --moves 8 --adapt --waste-free 4 "
                  "--project-every 2 --record full".split())


def test_updater_estimators_match_weighted_moments():
    u = qt.SMCUpdater(qt.SimplePrecessionModel(), 2000,
                      qt.UniformDistribution([[0.0, 1.0]]), seed=3,
                      device="cpu")
    for t, o in ((1.0, 0), (4.0, 1), (9.0, 0)):
        u.update(o, {"t": torch.tensor([t])})
    w = u.particle_weights.numpy().astype(np.float64)
    x = u.particle_locations.numpy().astype(np.float64)
    mu = w @ x
    np.testing.assert_allclose(u.est_mean().numpy(), mu, rtol=1e-5)
    cov = ((x - mu) * w[:, None]).T @ (x - mu)
    np.testing.assert_allclose(u.est_covariance_mtx().numpy(), cov,
                               rtol=1e-4)
    np.testing.assert_allclose(u.est_covariance_mtx(corr=True).numpy(),
                               [[1.0]], rtol=1e-6)
    assert u.n_ess == pytest.approx(1.0 / np.sum(w * w), rel=1e-4)
    assert len(u.data_record) == 3


def test_pgh_two_particles_match_jax():
    """With the posterior on two particles, PGH must pick both (the second
    draw excludes the first), so t = 1/|x₀ − x₁| exactly, in both
    packages."""
    n = 64
    locs = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
    w = np.zeros(n, np.float32)
    w[5], w[40] = 0.999, 0.001
    want = 1.0 / abs(float(locs[5, 0]) - float(locs[40, 0]))

    class _Holder:
        model = qt.SimplePrecessionModel()

    pgh = PGH(_Holder())
    for seed in range(5):
        eps = pgh.propose(torch.Generator().manual_seed(seed),
                          torch.from_numpy(w), torch.from_numpy(locs), seed)
        assert set(eps) == {"t"}
        assert float(eps["t"][0]) == pytest.approx(want, rel=1e-5)

    class _JaxHolder:
        model = q.SimplePrecessionModel()

    jeps = q.PGH(_JaxHolder()).propose(jax.random.key(0), jnp.asarray(w),
                                       jnp.asarray(locs), 0)
    assert float(jeps["t"][0]) == pytest.approx(want, rel=1e-5)


def test_categorical_inverse_cdf_frequencies():
    w = torch.tensor([0.1, 0.0, 0.6, 0.3])
    gen = torch.Generator().manual_seed(0)
    draws = np.array([int(categorical_inverse_cdf(gen, w)[0])
                      for _ in range(4000)])
    assert (draws != 1).all()
    freq = np.bincount(draws, minlength=4) / draws.size
    np.testing.assert_allclose(freq, w.numpy(), atol=0.03)


def test_simulate_experiment_frequencies_match_jax():
    """Outcome frequencies at ω = 0.7, t = 2 in both packages agree with
    Pr(0) = cos²(0.7) within 5 σ."""
    reps = 20000
    p0 = np.cos(0.7) ** 2
    got = qt.AcceleratedPrecessionModel().simulate_experiment(
        torch.Generator().manual_seed(0), torch.tensor([[0.7]]),
        {"t": torch.tensor([2.0])}, repeat=reps)
    want = JaxAcceleratedPrecessionModel().simulate_experiment(
        jax.random.key(0), jnp.asarray([[0.7]]), {"t": jnp.asarray([2.0])},
        repeat=reps)
    assert tuple(got.shape) == tuple(np.asarray(want).shape) == (reps, 1, 1)
    sigma = np.sqrt(p0 * (1 - p0) / reps)
    for out in (got.numpy(), np.asarray(want)):
        assert set(np.unique(out)) <= {0, 1}
        assert abs(np.mean(out == 0) - p0) < 5 * sigma


def test_pgh_takes_and_stores_maxiters_like_jax():
    class _Holder:
        model = qt.SimplePrecessionModel()

    class _JaxHolder:
        model = q.SimplePrecessionModel()

    assert PGH(_Holder()).maxiters == q.PGH(_JaxHolder()).maxiters == 10
    assert PGH(_Holder(), maxiters=3).maxiters == 3
    assert q.PGH(_JaxHolder(), maxiters=3).maxiters == 3
