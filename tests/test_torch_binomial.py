"""Parity of the port's binomial pmf and ``BinomialModel`` with the JAX
package, on the same NumPy inputs.

Tolerances:

* ``log_binomial_pdf``: −inf in the same places; elsewhere
  ``|Δ| ≤ 1e-5·|ref| + 4·ulp(max(lgamma(N + 1), 1))`` in float32. The
  log-binomial coefficient is a difference of three float32 ``lgamma``
  values up to lgamma(N + 1) ≈ 8.2e4 at N = 10⁴, each library's within
  ~2 ulp of float64 there (torch's within 1), so a result near 0 can
  differ by a few ulp of that magnitude. The port is also held to float64
  SciPy: 1e-5 relative plus 2 ulp. Subnormal p is left out: XLA on the CPU
  flushes it to zero (impossible), torch keeps it. ``binomial_pdf`` at
  N ≤ 64: rtol 1e-4 (4 ulp of lgamma(65) ≈ 205 is 6e-5 in the log).
* Likelihoods and update steps (n_meas ≤ 16): rtol 1e-5 (atol 1e-6 on
  logs near 0); weights to 1e-5 of their max and the evidence to rtol
  1e-5 after 40 steps, as ``test_torch_tomography_smc.py``.
* Simulated counts: statistical, within 5 σ of n·p in both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.special import gammaln

import qinfer_tpu as q
import qinfer_tpu.tomography as jtomo
from qinfer_tpu.ops.accelerated import (
    AcceleratedPrecessionModel as JaxAcceleratedPrecessionModel)
from qinfer_tpu.smc import SMCState as JaxSMCState
from qinfer_tpu.smc import _update_step as jax_update_step
from qinfer_tpu.utils import binomial_pdf as jax_binomial_pdf
from qinfer_tpu.utils import log_binomial_pdf as jax_log_binomial_pdf

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import tomography as ttomo
from qinfer_tpu_torch.convert import state_from_numpy, state_to_numpy
from qinfer_tpu_torch.smc import _update_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if f != "key"}


_PS = np.asarray([0.0, 1.0, 1e-35, 1e-30, 1e-7, 1e-6, 0.3, 0.5, 0.999,
                  1.0 - 1e-7, 1.0 - 1e-8, 0.6180339], np.float32)


@pytest.mark.parametrize("N", [1, 16, 64, 1000, 10_000])
def test_log_binomial_pdf_matches_jax(N):
    n = np.arange(N + 1, dtype=np.float32)
    NN, nn, pp = (a.ravel() for a in np.meshgrid(
        np.float32(N), n, _PS, indexing="ij"))
    want = np.asarray(jax_log_binomial_pdf(NN, nn, pp))
    got = qt.log_binomial_pdf(torch.from_numpy(NN), torch.from_numpy(nn),
                              torch.from_numpy(pp)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).any() and np.isfinite(got).any()
    ok = np.isfinite(want)
    ulp = np.spacing(np.float32(max(gammaln(N + 1.0), 1.0)))
    err = np.abs(got[ok] - want[ok])
    assert np.all(err <= 1e-5 * np.abs(want[ok]) + 4 * ulp), err.max()
    # and the port against float64
    pc = np.clip(pp.astype(np.float64), 1e-35, np.float64(np.float32(
        1.0 - 1e-7)))
    ref = (gammaln(NN + 1.0) - gammaln(nn + 1.0) - gammaln(NN - nn + 1.0)
           + nn * np.log(pc) + (NN - nn) * np.log1p(-pc))
    err64 = np.abs(got[ok] - ref[ok])
    assert np.all(err64 <= 1e-5 * np.abs(ref[ok]) + 2 * ulp), err64.max()


def test_log_binomial_pdf_marks_exactly_the_impossible_outcomes():
    got = qt.log_binomial_pdf(torch.tensor([4.0, 4.0, 4.0, 4.0, 4.0, 4.0]),
                              torch.tensor([0.0, 1.0, 4.0, 3.0, 0.0, 2.0]),
                              torch.tensor([0.0, 0.0, 1.0, 1.0, 1.0, 0.5]))
    assert torch.isneginf(got).tolist() == [False, True, False, True, True,
                                            False]
    assert float(got[0]) == pytest.approx(0.0, abs=1e-6)
    assert float(got[2]) == pytest.approx(0.0, abs=1e-6)


def test_binomial_pdf_matches_jax():
    rng = np.random.default_rng(4)
    N = rng.integers(0, 65, 500).astype(np.float32)
    n = np.floor(rng.random(500) * (N + 1)).astype(np.float32)
    p = rng.random(500).astype(np.float32)
    p[:20] = 0.0
    p[20:40] = 1.0
    want = np.asarray(jax_binomial_pdf(N, n, p))
    got = qt.binomial_pdf(torch.from_numpy(N), torch.from_numpy(n),
                          torch.from_numpy(p)).numpy()
    # the logs differ by up to 4 ulp of lgamma(65) ≈ 205 (6e-5); results
    # below float32's smallest normal are flushed to 0 by XLA on the CPU
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-37)
    impossible = ((p == 0) & (n > 0)) | ((p == 1) & (n < N))
    assert np.all(got[impossible] == 0) and np.all(want[impossible] == 0)


def _pair(kind):
    """(JAX model, port model): ``BinomialModel(·, n_meas_max=16)`` over a
    coin, precession or one-qubit process tomography."""
    if kind == "coin":
        return (q.BinomialModel(q.CoinModel(), n_meas_max=16),
                qt.BinomialModel(qt.CoinModel(), n_meas_max=16))
    if kind == "precession":
        return (q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=16),
                qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=16))
    return (q.BinomialModel(jtomo.ProcessTomographyModel(
                jtomo.pauli_basis(2), jtomo.pauli_basis(1)), n_meas_max=16),
            qt.BinomialModel(ttomo.ProcessTomographyModel(
                ttomo.pauli_basis(2), ttomo.pauli_basis(1)), n_meas_max=16))


def _fiducials(basis):
    kets = np.asarray([[1, 0], [0, 1],
                       [1 / np.sqrt(2), 1 / np.sqrt(2)],
                       [1 / np.sqrt(2), 1j / np.sqrt(2)]], np.complex64)
    return np.stack([np.asarray(basis.state_to_modelparams(
        np.outer(k, k.conj()))) for k in kets]).astype(np.float32)


def _inputs(kind, n=300, n_e=5, seed=0):
    """Particles and experiments for one model kind (NumPy): coin biases
    (0, 1 and the clip edges included), precession frequencies in [0, 1]
    and times, or JAX BCSZ Choi states and fiducial pairs. ``n_meas``
    varies across experiments (0 included)."""
    rng = np.random.default_rng(seed)
    n_meas = np.asarray([16, 5, 0, 1, 11][:n_e], np.int32)
    if kind == "coin":
        x = rng.random((n, 1), dtype=np.float32)
        x[:len(_PS), 0] = _PS
        eps = {"exp_num": np.zeros(n_e, np.int32)}
    elif kind == "precession":
        x = rng.random((n, 1), dtype=np.float32)
        eps = {"t": (rng.random(n_e) * 20).astype(np.float32)}
    else:
        jm = _pair("process")[0]
        x = np.asarray(jtomo.BCSZChoiDistribution(
            jm.underlying_model.basis).sample(jax.random.key(seed), n))
        fid = _fiducials(jtomo.pauli_basis(1))
        eps = {"prep": fid[rng.integers(0, 4, n_e)],
               "meas": fid[rng.integers(0, 4, n_e)]}
    eps["n_meas"] = n_meas
    return x, eps


@pytest.mark.parametrize("kind", ["coin", "precession", "process"])
def test_binomial_likelihood_matches_jax(kind):
    """Over the coin, Pr(0) is the particle itself in both packages, and
    the log-likelihoods agree to rtol 1e-5. Over precession and process
    tomography, each library computes Pr(0) in float32 its own way (cos,
    matrix products) to within ~2 ulp (2.4e-7), and the count's log
    amplifies that by κ = n/p + (N − n)/(1 − p) (p clipped as the pmf
    clips it): the tolerance adds κ·2.4e-7."""
    jm, tm = _pair(kind)
    x, eps = _inputs(kind)
    outcomes = np.arange(18, dtype=np.int32)  # 17 is past n_meas_max
    jeps = {k: jnp.asarray(v) for k, v in eps.items()}
    teps = {k: torch.from_numpy(v) for k, v in eps.items()}
    want_log = np.asarray(jm.log_likelihood(jnp.asarray(outcomes),
                                            jnp.asarray(x), jeps))
    got_log = tm.log_likelihood(torch.from_numpy(outcomes),
                                torch.tensor(x), teps).numpy()
    assert got_log.shape == want_log.shape == (18, x.shape[0], 5)
    np.testing.assert_array_equal(np.isneginf(got_log), np.isneginf(want_log))
    ok = np.isfinite(want_log)
    pr0 = np.asarray(jm.underlying_model.likelihood(
        jnp.asarray([0]), jnp.asarray(x),
        {k: v for k, v in jeps.items() if k != "n_meas"}))[0]
    pc = np.clip(pr0.astype(np.float64), 1e-35, 1.0 - 1.2e-7)[None]
    N = eps["n_meas"].astype(np.float64)[None, None, :]
    o = outcomes.astype(np.float64)[:, None, None]
    kappa = o / pc + np.abs(N - o) / (1.0 - pc)
    tol = np.where(ok, 1e-5 * np.abs(want_log) + 1e-6, 0.0)
    if kind != "coin":
        tol = tol + np.where(ok, 2.4e-7 * kappa, 0.0)
    err = np.abs(np.where(ok, got_log, 0.0) - np.where(ok, want_log, 0.0))
    assert np.all(err[ok] <= tol[ok]), (err[ok] / tol[ok]).max()
    want = np.asarray(jm.likelihood(jnp.asarray(outcomes), jnp.asarray(x),
                                    jeps))
    got = tm.likelihood(torch.from_numpy(outcomes), torch.tensor(x),
                        teps).numpy()
    # (XLA flushes results below float32's smallest normal to 0)
    assert np.all(np.abs(got - want)
                  <= 1e-37 + want * np.expm1(np.minimum(tol, 50.0)))
    assert np.all(got[~ok] == 0) and np.all(want[~ok] == 0)
    # the pmf over each experiment's counts sums to 1
    np.testing.assert_allclose(got.sum(axis=0), 1.0, rtol=1e-4)


@pytest.mark.parametrize("kind", ["coin", "precession", "process"])
def test_binomial_model_contract_matches_jax(kind):
    jm, tm = _pair(kind)
    _, eps = _inputs(kind)
    jeps = {k: jnp.asarray(v) for k, v in eps.items()}
    teps = {k: torch.from_numpy(v) for k, v in eps.items()}
    np.testing.assert_array_equal(tm.outcome_mask(teps).numpy(),
                                  np.asarray(jm.outcome_mask(jeps)))
    assert ([(dm.min, dm.max) for dm in tm.domain(teps)]
            == [(dj.min, dj.max) for dj in jm.domain(jeps)])
    assert (tm.domain().min, tm.domain().max) == (jm.domain().min,
                                                  jm.domain().max)
    assert tm.n_outcomes(teps) == jm.n_outcomes(jeps) == 17
    np.testing.assert_array_equal(tm.outcomes().numpy(),
                                  np.asarray(jm.outcomes()))
    assert ([tuple(f[:2]) for f in tm.expparams_dtype]
            == [tuple(f[:2]) for f in jm.expparams_dtype])
    assert tm.expparams_dtype[-1] == ("n_meas", "int32")
    assert tm.has_log_likelihood and jm.has_log_likelihood
    assert not tm.is_time_dependent and not jm.is_time_dependent
    assert not tm.is_n_outcomes_constant and not jm.is_n_outcomes_constant
    assert tm.n_modelparams == jm.n_modelparams
    assert tm.modelparam_names == list(jm.modelparam_names)
    assert ([type(m).__name__ for m in tm.model_chain]
            == [type(m).__name__ for m in jm.model_chain])
    assert tm.base_model is tm.underlying_model is tm.decorated_model
    # a decorator of the decorator delegates down the chain
    chain = qt.DerivedModel(tm)
    assert chain.base_model is tm.underlying_model
    assert [type(m) for m in chain.model_chain] == [
        qt.DerivedModel, qt.BinomialModel, type(tm.underlying_model)]
    assert chain.has_log_likelihood and not chain.is_time_dependent


class _DriftTorch(qt.SimplePrecessionModel):
    """Precession whose ω grows by 1e-3·t after every experiment."""

    def update_timestep(self, generator, modelparams, expparams):
        t = self.canonicalize_expparams(
            expparams, modelparams.device)["t"].reshape(-1)
        return modelparams[:, :, None] + 1e-3 * t[None, None, :]


class _LinearOnly(qt.DerivedModel):
    """A decorator that transforms the likelihood without a log form."""

    def likelihood(self, outcomes, modelparams, expparams):
        return 0.5 * self.underlying_model.likelihood(outcomes, modelparams,
                                                      expparams)


def test_time_dependence_and_log_path_follow_the_jax_rules():
    assert not qt.SimplePrecessionModel().is_time_dependent
    wrapped = qt.BinomialModel(_DriftTorch(), n_meas_max=4)
    assert wrapped.is_time_dependent
    x = torch.zeros((3, 1))
    eps = {"t": torch.tensor([2.0]), "n_meas": torch.tensor([4])}
    np.testing.assert_allclose(
        wrapped.update_timestep(None, x, eps)[:, 0, 0].numpy(), 2e-3)
    # a pure delegator asks the model below; a likelihood transform
    # without its own log form says no
    assert not qt.DerivedModel(qt.SimplePrecessionModel()).has_log_likelihood
    assert qt.DerivedModel(wrapped).has_log_likelihood
    assert not _LinearOnly(wrapped).has_log_likelihood
    with pytest.raises(ValueError, match="two-outcome"):
        qt.BinomialModel(wrapped)


def test_accelerated_binomial_takes_the_log_path(monkeypatch):
    """``BinomialModel(AcceleratedPrecessionModel)`` reweights through the
    log-binomial, never K1's single-shot hook (made to fail if called),
    and its weights follow the JAX ``BinomialModel`` over the same model.

    Tolerance: 1e-5 of the largest weight, plus each particle's share of
    the float32 cos difference between the libraries: a Pr(0) ~2 ulp
    apart (2.4e-7) moves a step's log-likelihood by κ·2.4e-7 (κ as in
    :func:`test_binomial_likelihood_matches_jax`); over the steps a
    weight moves by its own sum K_i of those, and by the weighted mean of
    all of them through the normalization."""
    tm = qt.BinomialModel(qt.AcceleratedPrecessionModel(), n_meas_max=12)
    jm = q.BinomialModel(JaxAcceleratedPrecessionModel(), n_meas_max=12)
    assert getattr(type(tm), "fused_reweight", None) is None

    def refuse(*args, **kwargs):
        raise AssertionError("the fused single-shot hook ran")

    monkeypatch.setattr(qt.AcceleratedPrecessionModel, "fused_reweight",
                        refuse)
    n = 4096
    rng = np.random.default_rng(2)
    x = rng.random((n, 1), dtype=np.float32)
    js = JaxSMCState.initial(jnp.asarray(x), jax.random.key(0))
    ts = state_from_numpy(_jax_arrays(js), device="cpu")
    gen = torch.Generator().manual_seed(0)
    K = np.zeros(n)
    for k in range(20):
        t = np.float32(1.3 ** k)
        count = int(rng.integers(0, 13))
        w_before = np.asarray(js.weights, np.float64)
        js, jlog, _ = jax_update_step(
            jm, q.LiuWestResampler(), js, jnp.asarray([count]),
            {"t": jnp.asarray([t]), "n_meas": jnp.asarray([12])}, 0.5, 1e-10,
            check_resample=False)
        ts, tlog, _ = _update_step(
            tm, qt.LiuWestResampler(), ts, torch.tensor([count]),
            {"t": torch.tensor([t]), "n_meas": torch.tensor([12])}, 0.5,
            1e-10, gen, check_resample=False)
        pc = np.clip(np.cos(x[:, 0].astype(np.float64) * t / 2) ** 2,
                     1e-35, 1.0 - 1.2e-7)
        step = 2.4e-7 * (count / pc + (12 - count) / (1.0 - pc))
        # the step's evidence moves by the posterior mean of this step's
        # differences and of the weights' differences so far
        post = w_before * np.exp(np.asarray(jm.log_likelihood(
            jnp.asarray([count]), jnp.asarray(x),
            {"t": jnp.asarray([t]), "n_meas": jnp.asarray([12])}),
            np.float64)[0, :, 0] - float(jlog))
        moved = step + 2 * (K + w_before @ K)
        assert abs(tlog - float(jlog)) <= (1e-5 * abs(float(jlog)) + 1e-5
                                           + float(post @ moved))
        K += step
    want, got = _jax_arrays(js), state_to_numpy(ts)
    w = want["weights"].astype(np.float64)
    tol = 1e-5 * w.max() + 2 * w * (K + w @ K)
    assert np.all(np.abs(got["weights"] - w) <= tol)


def test_process_binomial_update_steps_match_jax():
    """40 reweight steps of ``BinomialModel(ProcessTomographyModel)`` at
    16 shots on 3000 particles of ONE JAX prior draw."""
    jm, tm = _pair("process")
    n = 3000
    js = JaxSMCState.initial(
        jtomo.BCSZChoiDistribution(jm.underlying_model.basis).sample(
            jax.random.key(0), n), jax.random.key(1))
    ts = state_from_numpy(_jax_arrays(js), device="cpu")
    fid = _fiducials(jtomo.pauli_basis(1))
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        i, j = rng.integers(0, 4, 2)
        count = int(rng.integers(0, 17))
        js, jlog, _ = jax_update_step(
            jm, q.LiuWestResampler(), js, jnp.asarray([count]),
            {"prep": jnp.asarray(fid[i:i + 1]),
             "meas": jnp.asarray(fid[j:j + 1]),
             "n_meas": jnp.asarray([16])}, 0.5, 1e-10, check_resample=False)
        ts, tlog, _ = _update_step(
            tm, qt.LiuWestResampler(), ts, torch.tensor([count]),
            {"prep": torch.from_numpy(fid[i:i + 1]),
             "meas": torch.from_numpy(fid[j:j + 1]),
             "n_meas": torch.tensor([16])}, 0.5, 1e-10, gen,
            check_resample=False)
        np.testing.assert_allclose(tlog, float(jlog), rtol=1e-5, atol=1e-5)
    want, got = _jax_arrays(js), state_to_numpy(ts)
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-5 * want["weights"].max())
    np.testing.assert_allclose(got["log_total_likelihood"],
                               want["log_total_likelihood"], rtol=1e-5)
    np.testing.assert_array_equal(got["locations"], want["locations"])


def test_simulated_counts_match_jax():
    """Counts at Pr(0) = cos²(0.7·t/2) for n_meas 20, 3 and 0 in one call:
    each experiment's mean count within 5 σ of n_meas·p in both packages,
    and no count above its n_meas."""
    reps, ts, n_meas = 4000, [1.0, 2.0, 3.0], [20, 3, 0]
    tm = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=24)
    jm = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=24)
    got = tm.simulate_experiment(
        torch.Generator().manual_seed(0), torch.tensor([[0.7]]),
        {"t": torch.tensor(ts), "n_meas": torch.tensor(n_meas)},
        repeat=reps).numpy()
    want = np.asarray(jm.simulate_experiment(
        jax.random.key(0), jnp.asarray([[0.7]]),
        {"t": jnp.asarray(ts), "n_meas": jnp.asarray(n_meas)}, repeat=reps))
    assert got.shape == want.shape == (reps, 1, 3)
    assert got.dtype == np.int32
    for out in (got, want):
        for e, (t, m) in enumerate(zip(ts, n_meas)):
            p = np.cos(0.7 * t / 2) ** 2
            counts = out[:, 0, e]
            assert counts.min() >= 0 and counts.max() <= m
            sigma = np.sqrt(max(m * p * (1 - p), 1e-12) / reps)
            assert abs(counts.mean() - m * p) <= 5 * sigma + 1e-9
    one = tm.simulate_experiment(torch.Generator().manual_seed(1),
                                 torch.tensor([[0.7]]),
                                 {"t": torch.tensor([1.0]),
                                  "n_meas": torch.tensor([20])})
    assert tuple(one.shape) == (1, 1)
