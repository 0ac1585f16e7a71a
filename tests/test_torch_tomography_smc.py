"""The tomography slice end to end at small size, against the JAX package.

* Deterministic: one-qubit process tomography (embedded d = 8), 3000
  particles from ONE JAX prior draw carried across with
  ``convert.state_from_numpy``, the same 40 (prep, meas, outcome)
  triples, ``check_resample=False``: weights to 1e-5 of their max and the
  evidence to rtol 1e-5 (float32 reduction order, as in
  ``test_torch_smc.py``).
* The time-dependent branch of ``_update_step`` (reweight, then
  ``update_timestep``, then the ESS check) and of ``perf_test``, on a
  precession model with a deterministic drift in both packages: the
  weights to 1e-5 of their max and the drifted locations and truth to
  1e-6.
* Stochastic: the full loop with Liu-West resampling. Threefry and Philox
  never match, so the comparison is statistical: one-qubit process
  tomography, 1000 particles, 150 steps, three seeds in each package; the
  port's mean fidelity within 0.08 of the JAX package's (the per-seed
  spread is ~0.04) and every run above the prior mean's fidelity. A
  two-qubit diffusive run (1000 particles, 60 steps; the JAX package's
  eager loop takes minutes at this size, so its band at 2000 particles,
  0.630 and 0.679 on seeds 0 and 1, is quoted): the port's run beats the
  prior mean and lands in [0.55, 0.80].
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
import qinfer_tpu.tomography as jtomo
from qinfer_tpu.perf_testing import perf_test as jax_perf_test
from qinfer_tpu.resamplers import LiuWestResampler as JaxLiuWest
from qinfer_tpu.smc import SMCState as JaxSMCState
from qinfer_tpu.smc import _update_step as jax_update_step

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import tomography_bench as tb
from qinfer_tpu_torch.convert import state_from_numpy, state_to_numpy
from qinfer_tpu_torch.smc import _update_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run thousands of small ops; with several test
    workers on one machine, torch's default of one thread per core
    oversubscribes the cores many times over. One thread keeps them fast."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if f != "key"}


def _fiducials(basis):
    kets = np.asarray([[1, 0], [0, 1],
                       [1 / np.sqrt(2), 1 / np.sqrt(2)],
                       [1 / np.sqrt(2), 1j / np.sqrt(2)]], np.complex64)
    return np.stack([np.asarray(basis.state_to_modelparams(
        np.outer(k, k.conj()))) for k in kets]).astype(np.float32)


def _process_truth():
    J = np.zeros((4, 4), np.complex64)
    for a in range(2):
        for b in range(2):
            E = np.zeros((2, 2), np.complex64)
            E[a, b] = 1
            J += np.kron(E, E)
    return (0.75 * J + 0.25 * np.kron(np.eye(2), np.eye(2) / 2)) / 2


def test_process_update_steps_match_jax():
    jm = jtomo.ProcessTomographyModel(jtomo.pauli_basis(2),
                                      jtomo.pauli_basis(1))
    tm = tb.make_config("process", torch.device("cpu"), 1).model
    n = 3000
    js = JaxSMCState.initial(
        jtomo.BCSZChoiDistribution(jm.basis).sample(jax.random.key(0), n),
        jax.random.key(1))
    ts = state_from_numpy(_jax_arrays(js), device="cpu")
    fid = _fiducials(jtomo.pauli_basis(1))
    rng = np.random.default_rng(3)
    jrs, trs = JaxLiuWest(), qt.LiuWestResampler()
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        i, j = rng.integers(0, 4, 2)
        outcome = int(rng.integers(0, 2))
        js, jlog, _ = jax_update_step(
            jm, jrs, js, jnp.asarray([outcome]),
            {"prep": jnp.asarray(fid[i:i + 1]),
             "meas": jnp.asarray(fid[j:j + 1])}, 0.5, 1e-10,
            check_resample=False)
        ts, tlog, _ = _update_step(
            tm, trs, ts, torch.tensor([outcome]),
            {"prep": torch.from_numpy(fid[i:i + 1]),
             "meas": torch.from_numpy(fid[j:j + 1])}, 0.5, 1e-10, gen,
            check_resample=False)
        np.testing.assert_allclose(tlog, float(jlog), rtol=1e-5, atol=1e-6)
    want, got = _jax_arrays(js), state_to_numpy(ts)
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-5 * want["weights"].max())
    np.testing.assert_allclose(got["log_total_likelihood"],
                               want["log_total_likelihood"], rtol=1e-5)
    np.testing.assert_allclose(got["min_n_ess"], want["min_n_ess"],
                               rtol=1e-4)
    np.testing.assert_array_equal(got["locations"], want["locations"])


DRIFT = 1e-3


class _DriftJax(q.SimplePrecessionModel):
    """Precession whose ω grows by DRIFT·t after every experiment."""

    def update_timestep(self, key, modelparams, expparams):
        t = jnp.atleast_1d(self.canonicalize_expparams(expparams)["t"])
        return modelparams[:, :, None] + DRIFT * t[None, None, :]


class _DriftTorch(qt.SimplePrecessionModel):
    def update_timestep(self, generator, modelparams, expparams):
        t = self.canonicalize_expparams(
            expparams, modelparams.device)["t"].reshape(-1)
        return modelparams[:, :, None] + DRIFT * t[None, None, :]


def test_time_dependent_update_step_matches_jax():
    assert _DriftTorch().is_time_dependent
    assert not qt.SimplePrecessionModel().is_time_dependent
    n = 2048
    rng = np.random.default_rng(5)
    js = JaxSMCState.initial(
        jnp.asarray(rng.random((n, 1), dtype=np.float32)),
        jax.random.key(0))
    ts = state_from_numpy(_jax_arrays(js), device="cpu")
    jm, tm = _DriftJax(), _DriftTorch()
    gen = torch.Generator().manual_seed(0)
    for k in range(15):
        t = np.float32(1.3 ** k)
        outcome = int(rng.integers(0, 2))
        js, _, _ = jax_update_step(
            jm, q.LiuWestResampler(), js, jnp.asarray([outcome]),
            {"t": jnp.asarray([t])}, 0.5, 1e-10, check_resample=False)
        ts, _, _ = _update_step(
            tm, qt.LiuWestResampler(), ts, torch.tensor([outcome]),
            {"t": torch.tensor([t])}, 0.5, 1e-10, gen,
            check_resample=False)
    want, got = _jax_arrays(js), state_to_numpy(ts)
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-5 * want["weights"].max())
    np.testing.assert_allclose(got["locations"], want["locations"],
                               atol=1e-6, rtol=0)
    drift = DRIFT * sum(1.3 ** k for k in range(15))
    np.testing.assert_allclose(got["locations"] - np.asarray(
        JaxSMCState.initial(jnp.asarray(np.random.default_rng(5).random(
            (n, 1), dtype=np.float32)), jax.random.key(0)).locations),
        drift, atol=1e-5)


class _FixedTJax(q.Heuristic):
    def propose(self, key, weights, locations, idx_exp):
        return {"t": jnp.asarray([2.0], jnp.float32)}


class _FixedTTorch(qt.Heuristic):
    def propose(self, generator, weights, locations, idx_exp):
        return {"t": torch.tensor([2.0], device=locations.device)}


def test_time_dependent_perf_test_moves_the_truth_like_jax():
    n_exp = 25
    want = 0.5 + DRIFT * 2.0 * n_exp
    _, extra_t = qt.perf_test(_DriftTorch(), 512,
                              qt.UniformDistribution([[0.0, 1.0]]), n_exp,
                              heuristic_class=_FixedTTorch,
                              true_mps=[[0.5]], seed=2, device="cpu")
    _, extra_j = jax_perf_test(_DriftJax(), 512,
                               q.UniformDistribution([[0.0, 1.0]]), n_exp,
                               heuristic_class=_FixedTJax,
                               true_mps=[[0.5]], seed=2)
    for extra in (extra_t, extra_j):
        np.testing.assert_allclose(np.asarray(extra["true_mps"]), [[want]],
                                   atol=1e-6)


def _process_fidelity_jax(seed, n=1000, steps=150):
    jm = jtomo.ProcessTomographyModel(jtomo.pauli_basis(2),
                                      jtomo.pauli_basis(1))
    rs = JaxLiuWest(a=0.98, maxiter=4, canonicalize=True)
    fid = _fiducials(jtomo.pauli_basis(1))
    true_rho = _process_truth()
    true = jnp.asarray(np.asarray(jm.states_to_modelparams(true_rho[None])))
    key = jax.random.key(seed)
    st = JaxSMCState.initial(jtomo.BCSZChoiDistribution(jm.basis).sample(
        jax.random.fold_in(key, 1), n), jax.random.fold_in(key, 2))
    rng = np.random.default_rng(seed)
    for k in range(steps):
        i, j = rng.integers(0, 4, 2)
        eps = {"prep": jnp.asarray(fid[i][None]),
               "meas": jnp.asarray(fid[j][None])}
        o = jm.simulate_experiment(jax.random.fold_in(key, 100 + k), true,
                                   eps)
        st, _, _ = jax_update_step(jm, rs, st,
                                   jnp.asarray(o).reshape(-1)[:1], eps,
                                   0.5, 1e-10)
    est = np.asarray(st.weights) @ np.asarray(st.locations)
    return float(np.asarray(jm.fidelity_with(est[None], true_rho))[0])


def test_process_loop_fidelity_is_in_the_jax_band():
    cfg = tb.make_config("process", torch.device("cpu"), 1)
    port = [tb.timed_run(cfg, 1000, 150, seed, torch.device("cpu"))
            for seed in range(3)]
    jax_f = [_process_fidelity_jax(seed) for seed in range(3)]
    port_f = [r["fidelity"] for r in port]
    for r in port:
        assert r["fidelity"] > r["prior_fidelity"] + 0.05
        assert r["state"].resample_count >= 1
        assert r["projections"] >= 1
        assert bool(torch.isfinite(r["state"].locations).all())
    assert abs(np.mean(port_f) - np.mean(jax_f)) < 0.08, (port_f, jax_f)


def test_diffusive_loop_tracks_the_diffusing_state():
    cfg = tb.make_config("diffusive", torch.device("cpu"))
    r = tb.timed_run(cfg, 1000, 60, 0, torch.device("cpu"))
    assert r["fidelity"] > r["prior_fidelity"]
    assert 0.55 <= r["fidelity"] <= 0.80
    # the truth diffused and every step projected some particles back
    assert not torch.equal(r["true"], cfg.true_mps)
    assert r["projections"] >= 60
    assert bool(cfg.model.are_models_valid(r["state"].locations).all())
