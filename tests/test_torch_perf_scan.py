"""Parity of the port's trial engines (``perf_test_scan``,
``perf_test_scan_batch`` batched and on a mesh) against the JAX package.

The two packages draw from different random streams (a torch.Generator
against JAX keys), so a run is held to the JAX tests' own bars
(``tests/test_heuristics_expdesign.py``, ``tests/test_round4_fixes.py``),
in both packages on the same configuration: final loss < 1e-2 at
1000 particles x 50 steps; median final loss < 5e-2 over 4 trials of
256 x 25; interval 0 equal to interval 1 at rtol 1e-5; interval 8's
median final/first loss ratio < 1e-2. Shapes and keys equal JAX's.
Batched and sequential runs agree statistically: their mean final loss
and mean final log-loss over 16 trials within 4 Monte-Carlo errors. The
vmapped likelihood of the batched reweight equals the per-trial reweight
at rtol 1e-6 (a few float32 ulps of a sum's order), and so does the
per-trial route (a hand kernel's model) against the plain model's
vmapped one. The batched engine's own steps are also held to JAX's
vmapped ones on the same NumPy inputs: the reweight on its linear and
log routes, the outcome simulation's likelihood table and draws, and
PGH's proposal fields (tolerances in each test's docstring).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import qinfer_tpu as q
from qinfer_tpu import smc as jsmc
from qinfer_tpu.perf_testing import perf_test_scan as jax_scan
from qinfer_tpu.perf_testing import perf_test_scan_batch as jax_batch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch import smc as tsmc
from qinfer_tpu_torch.perf_testing import (perf_test_scan,
                                           perf_test_scan_batch)

CPU = torch.device("cpu")


def _prec():
    return (q.SimplePrecessionModel(), q.UniformDistribution([[0.0, 1.0]]),
            qt.SimplePrecessionModel(), qt.UniformDistribution([[0.0, 1.0]]))


def test_perf_test_scan_converges_in_both_packages():
    jm, jp, tm, tp = _prec()
    ju, jrec = jax_scan(jm, 1000, jp, 50, seed=3)
    tu, trec = perf_test_scan(tm, 1000, tp, 50, seed=3, device="cpu")
    assert set(trec) == set(jrec) | {"true_mps"}
    for rec in (jrec, trec):
        assert float(rec["loss"][-1]) < 1e-2
        assert tuple(rec["est"].shape) == (50, 1)
        assert tuple(rec["loss"].shape) == tuple(rec["ess"].shape) == (50,)
        assert tuple(rec["norm"].shape) == (50,)
    assert tuple(trec["true_mps"].shape) == tuple(jrec["true_mps"].shape)
    # the committed state is the record's last step
    np.testing.assert_allclose(tu.est_mean().numpy(),
                               trec["est"][-1].numpy(), atol=1e-6)
    assert tu.resample_count > 0
    assert bool((trec["norm"] > 0).all() & (trec["norm"] <= 1).all())


def test_perf_test_scan_takes_a_heuristic_factory_and_a_truth():
    _, _, tm, tp = _prec()
    u, rec = perf_test_scan(
        tm, 500, tp, 40, heuristic_factory=lambda up: qt.ExpSparseHeuristic(
            up, scale=0.2, base=9 / 8), true_mps=[[0.3]], seed=1,
        device="cpu")
    assert float(rec["true_mps"][0, 0]) == pytest.approx(0.3)
    assert abs(float(rec["est"][-1, 0]) - 0.3) < 0.05


def test_perf_test_scan_moves_a_time_dependent_truth():
    """A random-walk model moves the true parameters after each outcome,
    as JAX's perf_test_scan does; the truth's final value is returned."""
    model = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                               qt.NormalDistribution(0.0, 0.01 ** 2))
    _, rec = perf_test_scan(model, 500, qt.UniformDistribution([[0.4, 0.6]]),
                            20, true_mps=[[0.5]], seed=2, device="cpu")
    assert float(rec["true_mps"][0, 0]) != 0.5
    assert bool(torch.isfinite(rec["loss"]).all())


def test_scan_batch_keys_shapes_and_convergence_match_jax():
    jm, jp, tm, tp = _prec()
    jrec = jax_batch(jm, 256, jp, 25, n_trials=4, seed=0)
    trec = perf_test_scan_batch(tm, 256, tp, 25, n_trials=4, seed=0,
                                device="cpu")
    assert set(trec) == set(jrec)
    for k in jrec:
        assert tuple(trec[k].shape) == tuple(jrec[k].shape), k
    for rec in (jrec, trec):
        assert float(np.median(np.asarray(rec["loss"])[:, -1])) < 5e-2


def test_scan_batch_on_a_mesh_and_its_refusal():
    jm, jp, tm, tp = _prec()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("trials",))
    jrec = jax_batch(jm, 256, jp, 25, n_trials=8, seed=1, mesh=mesh)
    trec = perf_test_scan_batch(tm, 256, tp, 25, n_trials=8, seed=1,
                                mesh=[CPU, CPU])
    for rec in (jrec, trec):
        assert tuple(rec["loss"].shape) == (8, 25)
        assert tuple(rec["final_locations"].shape) == (8, 256, 1)
        assert float(np.median(np.asarray(rec["loss"])[:, -1])) < 5e-2
    with pytest.raises(ValueError):
        jax_batch(jm, 256, jp, 5, n_trials=3, mesh=mesh)
    with pytest.raises(ValueError, match="must divide"):
        perf_test_scan_batch(tm, 256, tp, 5, n_trials=3, mesh=[CPU, CPU])


@pytest.mark.parametrize("mesh", [None, [CPU]])
def test_return_runner_reproduces_the_run(mesh):
    _, _, tm, tp = _prec()
    rec = perf_test_scan_batch(tm, 256, tp, 25, n_trials=4, seed=0,
                               mesh=mesh, device="cpu")
    runner, seeds = perf_test_scan_batch(tm, 256, tp, 25, n_trials=4,
                                         seed=0, mesh=mesh, device="cpu",
                                         return_runner=True)
    assert len(seeds) == 4
    for _ in range(2):
        again = runner(seeds)
        for k in rec:
            assert torch.equal(again[k], rec[k]), k
    assert len(runner.resample_counts) == 4
    assert all(c > 0 for c in runner.resample_counts)


def test_interval_0_equals_interval_1_and_interval_8_converges():
    jm, jp, tm, tp = _prec()
    for batch, kw in ((jax_batch, {}), (perf_test_scan_batch,
                                        {"device": "cpu"})):
        model, prior = (jm, jp) if batch is jax_batch else (tm, tp)
        rec0 = batch(model, 1024, prior, 40, n_trials=3, seed=9,
                     resample_interval=0, **kw)
        rec1 = batch(model, 1024, prior, 40, n_trials=3, seed=9,
                     resample_interval=1, **kw)
        np.testing.assert_allclose(np.asarray(rec0["loss"]),
                                   np.asarray(rec1["loss"]), rtol=1e-5)
        rec8 = batch(model, 1024, prior, 40, n_trials=3, seed=9,
                     resample_interval=8, **kw)
        loss = np.asarray(rec8["loss"])
        assert np.median(loss[:, -1] / np.maximum(loss[:, 0], 1e-30)) < 1e-2


def test_interval_gate_resamples_only_on_eligible_steps():
    """With interval 8 a trial resamples at most once every 8 steps."""
    _, _, tm, tp = _prec()
    runner, seeds = perf_test_scan_batch(tm, 512, tp, 40, n_trials=4,
                                         seed=5, resample_interval=8,
                                         return_runner=True, device="cpu")
    runner(seeds)
    assert all(1 <= c <= 5 for c in runner.resample_counts)


def test_batched_and_sequential_agree_statistically():
    """16 trials of 256 x 25 in each mode: the same priors and truths (the
    trial seeds), and the mean final loss and mean final log10-loss within
    4 Monte-Carlo errors."""
    _, _, tm, tp = _prec()
    b = perf_test_scan_batch(tm, 256, tp, 25, n_trials=16, seed=4,
                             device="cpu")
    s = perf_test_scan_batch(tm, 256, tp, 25, n_trials=16, seed=4,
                             mesh=[CPU, CPU, CPU, CPU])
    assert torch.equal(b["true_mps"], s["true_mps"])
    for f in (lambda v: v, lambda v: np.log10(v + 1e-30)):
        lb = f(b["loss"][:, -1].numpy().astype(np.float64))
        ls = f(s["loss"][:, -1].numpy().astype(np.float64))
        err = np.sqrt(lb.var(ddof=1) / lb.size + ls.var(ddof=1) / ls.size)
        assert abs(lb.mean() - ls.mean()) <= 4 * err


def _batch_inputs(seed, T=3, n=400):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((T, n, 1), generator=g)
    w = torch.rand((T, n), generator=g)
    w = w / w.sum(dim=1, keepdim=True)
    eps = {"t": torch.rand((T, 1), generator=g) * 20}
    return w, x, eps


@pytest.mark.parametrize("model", [
    qt.SimplePrecessionModel(),
    qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=8),
], ids=["linear", "log"])
def test_vmapped_reweight_equals_the_per_trial_reweight(model):
    """The one-call route (torch.func.vmap over the trials) against
    ``smc._reweight`` trial by trial."""
    w, x, eps = _batch_inputs(0)
    T = w.shape[0]
    if isinstance(model, qt.BinomialModel):
        eps = dict(eps, n_meas=torch.full((T, 1), 8, dtype=torch.int32))
        outcomes = torch.tensor([0, 3, 8])
    else:
        outcomes = torch.tensor([0, 1, 1])
    assert not tsmc._one_call_a_trial(model)
    hyp, norm = tsmc._reweight_batch(model, w, x, outcomes, eps)
    for t in range(T):
        h, nm, _ = tsmc._reweight(model, w[t], x[t], outcomes[t],
                                  {k: v[t] for k, v in eps.items()})
        torch.testing.assert_close(hyp[t], h, rtol=1e-6, atol=0)
        torch.testing.assert_close(norm[t], nm, rtol=1e-6, atol=0)


def _jax_reweight_batch(model, w, x, outcomes, eps):
    """JAX's batched reweight: ``smc._reweight`` vmapped over the trials,
    as ``perf_test_scan_batch`` runs it with ``mesh=None``."""
    hyp, norm, _ = jax.vmap(
        lambda w_, x_, o_, e_: jsmc._reweight(model, w_, x_, o_, e_, None))(
        jnp.asarray(w), jnp.asarray(x), jnp.asarray(outcomes),
        {k: jnp.asarray(v) for k, v in eps.items()})
    return np.asarray(hyp), np.asarray(norm)


def _np_batch(seed, T=4, n=4000, outcomes=2):
    rng = np.random.default_rng(seed)
    x = rng.random((T, n, 1)).astype(np.float32)
    w = rng.random((T, n)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    t = (rng.random((T, 1)) * 20).astype(np.float32)
    return w, x, t, rng.integers(0, outcomes, T)


def _torch_batch(w, x, outcomes, eps):
    return (torch.from_numpy(w), torch.from_numpy(x),
            torch.from_numpy(outcomes),
            {k: torch.from_numpy(v) for k, v in eps.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_reweight_equals_jax_vmapped_reweight_linear(seed):
    """The linear route on the same NumPy (w, x, outcomes): the coin,
    whose likelihood (p or 1 − p) is one IEEE operation in both packages,
    gives JAX's hyp to the bit and its norm at rtol 1e-6 (another
    summation order of 4000 terms); the precession model of the trials
    path, whose cos² may differ by two float32 ulps of 1 between XLA and
    torch, gives each hyp_i within 2.4e-7·w_i (atol 2.4e-7·max w) plus
    rtol 1e-6, and the norm within 2.4e-7·Σw (atol 2.4e-7) plus rtol
    1e-6."""
    w, x, t, o = _np_batch(seed)
    for jm, tm, eps, bits in (
            (q.CoinModel(), qt.CoinModel(), {}, True),
            (q.SimplePrecessionModel(), qt.SimplePrecessionModel(),
             {"t": t}, False)):
        jh, jn = _jax_reweight_batch(jm, w, x, o, eps)
        assert not tsmc._one_call_a_trial(tm)
        th, tn = tsmc._reweight_batch(tm, *_torch_batch(w, x, o, eps))
        if bits:
            np.testing.assert_array_equal(th.numpy(), jh)
            np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(th.numpy(), jh, rtol=1e-6,
                                       atol=2.4e-7 * float(w.max()))
            np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6,
                                       atol=2.4e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_reweight_equals_jax_vmapped_reweight_log(seed):
    """The max-shifted log route (a binomial coin of 8 shots) on the same
    NumPy (w, x, outcomes, n_meas): hyp_i = exp(log w_i + log L_i − M) is
    held at rtol 1.5e-5 (16 float32 ulps of |log w| ≈ 8.3 at n = 4000:
    the exponent's terms are rounded to their own ulps, and XLA's and
    torch's float32 log and lgamma differ by an ulp or two), and so is the
    shifted norm; a trial whose outcome is impossible for every particle
    (a zero column) reports norm 0 in both."""
    w, x, _, o = _np_batch(seed, outcomes=9)
    x[3, :, 0] = 0.0  # p = 0: outcome k > 0 impossible everywhere
    o[3] = 5
    eps = {"n_meas": np.full((w.shape[0], 1), 8, np.int32)}
    jm = q.BinomialModel(q.CoinModel(), n_meas_max=8)
    tm = qt.BinomialModel(qt.CoinModel(), n_meas_max=8)
    jh, jn = _jax_reweight_batch(jm, w, x, o, eps)
    th, tn = tsmc._reweight_batch(tm, *_torch_batch(w, x, o, eps))
    assert float(jn[3]) == float(tn[3]) == 0.0
    np.testing.assert_allclose(th.numpy(), jh, rtol=1.5e-5, atol=0)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1.5e-5, atol=0)


@pytest.mark.parametrize("binomial", [False, True], ids=["two", "binomial"])
def test_batched_outcome_table_and_draws_equal_jax(binomial):
    """``_simulate_batch``'s likelihood table (one vmapped call over 64
    trials, each at its own truth and t) against JAX's vmapped likelihood:
    cos² within two float32 ulps of 1 (atol 2.4e-7), the binomial pmf of 8
    shots, exp of a float32 sum of lgammas and logs, within 16 (atol
    1.9e-6). The two-outcome model's draws (the generic sampler: one
    uniform a trial), replayed from the generator's state, are the
    inverse CDF of JAX's table at the same uniforms; the binomial model
    draws with its own sampler, one call a trial."""
    rng = np.random.default_rng(5)
    T = 64
    true = rng.random((T, 1, 1)).astype(np.float32)
    eps = {"t": (rng.random((T, 1)) * 40).astype(np.float32)}
    if binomial:
        jm = q.BinomialModel(q.SimplePrecessionModel(), n_meas_max=8)
        tm = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=8)
        eps["n_meas"] = np.full((T, 1), 8, np.int32)
        atol = 1.9e-6
    else:
        jm, tm = q.SimplePrecessionModel(), qt.SimplePrecessionModel()
        atol = 2.4e-7
    teps = {k: torch.from_numpy(v) for k, v in eps.items()}
    outs = tm.outcomes(tsmc._trial(teps, 0))
    jL = np.asarray(jax.vmap(
        lambda x_, e_: jm.likelihood(jnp.asarray(outs.numpy()), x_, e_)[
            :, 0, 0])(jnp.asarray(true),
                      {k: jnp.asarray(v) for k, v in eps.items()}))
    tL = tsmc._outcome_likelihoods(tm, outs, torch.from_numpy(true), teps)
    assert tuple(tL.shape) == (T, outs.shape[0])
    np.testing.assert_allclose(tL.numpy(), jL, rtol=0, atol=atol)
    if binomial:
        return
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    drawn = tsmc._simulate_batch(tm, g, torch.from_numpy(true), teps)
    u = torch.rand((T, 1), generator=torch.Generator().set_state(state))
    cdf = np.cumsum(np.maximum(jL, tsmc.EPS), axis=1, dtype=np.float32)
    idx = np.sum(cdf <= u.numpy() * cdf[:, -1:], axis=1)
    np.testing.assert_array_equal(
        drawn.numpy(), outs.numpy()[np.minimum(idx, outs.shape[0] - 1)])


def test_pgh_batched_proposal_matches_the_single_one_and_jax():
    """PGH over T ensembles: at T = 1 the batched proposal is the single
    one to the bit (same stream, same draws, same fields), with and
    without ``t_func``, ``inv_func`` and ``other_fields``; at T = 5 each
    row's inversion field is a particle x₁ of its own ensemble and its t
    is 1/‖x₁ − x₂‖ (rtol 1e-6) for another particle x₂ of it; the
    fields' names and per-row shapes equal those of JAX's
    ``PGH.propose`` on the same model."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((5, 300, 1)).astype(np.float32))
    w = torch.from_numpy(rng.random((5, 300)).astype(np.float32))
    w = w / w.sum(dim=1, keepdim=True)

    def stub(model):
        return type("Stub", (), {"model": model})()

    for kw in ({}, {"t_func": lambda t: 2 * t, "inv_func": lambda v: -v,
                    "other_fields": {"k": 3}}):
        pgh = qt.PGH(stub(qt.SimpleInversionModel()), inv_field="w_", **kw)
        one = pgh.propose(torch.Generator().manual_seed(4), w[0], x[0], 0)
        row = pgh.propose_batch(torch.Generator().manual_seed(4), w[:1],
                                x[:1], 0)
        assert one.keys() == row.keys()
        for k in one:
            assert torch.equal(row[k][0], one[k]), k
    for jm, tm in ((q.SimpleInversionModel(), qt.SimpleInversionModel()),
                   (q.SimplePrecessionModel(), qt.SimplePrecessionModel())):
        eps = qt.PGH(stub(tm), inv_field="w_").propose_batch(
            torch.Generator().manual_seed(0), w, x, 0)
        jeps = q.PGH(stub(jm), inv_field="w_").propose(
            jax.random.key(0), jnp.asarray(w[0].numpy()),
            jnp.asarray(x[0].numpy()), 0)
        assert eps.keys() == jeps.keys()
        for k in jeps:
            assert tuple(eps[k].shape) == (5,) + tuple(jeps[k].shape), k
    eps_inv = qt.PGH(stub(qt.SimpleInversionModel()), inv_field="w_"
                     ).propose_batch(torch.Generator().manual_seed(0), w, x,
                                     0)
    for t in range(5):
        x1 = eps_inv["w_"][t, 0]
        assert bool((x[t, :, 0] == x1).any())
        d = (x[t, :, 0] - x1).abs()
        partner = torch.isclose(d * eps_inv["t"][t, 0], torch.tensor(1.0),
                                rtol=1e-6)
        assert bool(partner.any())


def test_kernel_model_takes_one_call_a_trial(monkeypatch):
    """``AcceleratedPrecessionModel`` reaches K1 through fused_reweight:
    one call a trial a step, equal to the plain model's batched reweight,
    and a batched run makes T x steps of those calls."""
    model = qt.AcceleratedPrecessionModel()
    assert tsmc._one_call_a_trial(model)
    w, x, eps = _batch_inputs(1)
    outcomes = torch.tensor([1, 0, 1])
    hyp, norm = tsmc._reweight_batch(model, w, x, outcomes, eps)
    hyp_p, norm_p = tsmc._reweight_batch(qt.SimplePrecessionModel(), w, x,
                                         outcomes, eps)
    torch.testing.assert_close(hyp, hyp_p, rtol=1e-6, atol=1e-12)
    torch.testing.assert_close(norm, norm_p, rtol=1e-5, atol=0)
    calls = []
    fused = type(model).fused_reweight

    def counted(self, *args):
        calls.append(1)
        return fused(self, *args)

    monkeypatch.setattr(type(model), "fused_reweight", counted)
    rec = perf_test_scan_batch(model, 256, qt.UniformDistribution([[0, 1]]),
                               10, n_trials=3, seed=0, device="cpu")
    assert len(calls) == 3 * 10
    assert float(np.median(rec["loss"][:, -1].numpy())) < 5e-2


def test_batched_simulation_follows_each_trials_truth():
    """The vmapped outcome draw: trial t's outcome 0 with probability
    cos²(ω_t t_t / 2); 4000 draws of 3 trials within 4 binomial sd."""
    model = qt.SimplePrecessionModel()
    true = torch.tensor([[[0.2]], [[0.7]], [[0.9]]])
    eps = {"t": torch.tensor([[1.0], [2.0], [3.0]])}
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([tsmc._simulate_batch(model, g, true, eps)
                         for _ in range(4000)])
    p0 = torch.cos(true[:, 0, 0] * eps["t"][:, 0] / 2) ** 2
    freq = (draws == 0).double().mean(0)
    sd = torch.sqrt(p0 * (1 - p0) / 4000)
    assert bool(((freq - p0).abs() <= 4 * sd + 1e-12).all())


@pytest.mark.parametrize("mesh", [None, [CPU]])
def test_scan_batch_with_moves_converges(mesh):
    """Metropolis moves after each resample of a trial, over its own
    record: a binomial precession run still converges."""
    model = qt.BinomialModel(qt.SimplePrecessionModel(), n_meas_max=4)

    def factory(stub):
        return qt.PGH(stub, other_fields={"n_meas": 4})

    rec = perf_test_scan_batch(model, 256, qt.UniformDistribution([[0, 1]]),
                               20, n_trials=2, seed=3, mesh=mesh,
                               heuristic_factory=factory, n_mcmc_moves=2,
                               device="cpu")
    assert tuple(rec["final_locations"].shape) == (2, 256, 1)
    assert float(np.median(rec["loss"][:, -1].numpy())) < 5e-2


def test_moves_refuse_a_time_dependent_model_in_both_packages():
    jmodel = q.RandomWalkModel(q.SimplePrecessionModel(),
                               q.NormalDistribution(0.0, 1e-4))
    tmodel = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                                qt.NormalDistribution(0.0, 1e-4))
    with pytest.raises(ValueError, match="time-dependent"):
        jax_batch(jmodel, 64, q.UniformDistribution([[0, 1]]), 3, 2,
                  n_mcmc_moves=1)
    with pytest.raises(ValueError, match="time-dependent"):
        perf_test_scan_batch(tmodel, 64, qt.UniformDistribution([[0, 1]]),
                             3, 2, n_mcmc_moves=1, device="cpu")


def test_batched_run_moves_time_dependent_truths():
    model = qt.RandomWalkModel(qt.SimplePrecessionModel(),
                               qt.NormalDistribution(0.0, 0.01 ** 2))
    prior = qt.UniformDistribution([[0.4, 0.6]])
    rec = perf_test_scan_batch(model, 256, prior, 15, 2, seed=0,
                               device="cpu")
    # the same trial seeds draw the same starting truths for a static model
    start = perf_test_scan_batch(qt.SimplePrecessionModel(), 256, prior, 1,
                                 2, seed=0, device="cpu")["true_mps"]
    assert bool((rec["true_mps"] != start).all())
    assert bool(torch.isfinite(rec["loss"]).all())


def test_trial_engines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only on a machine without a card")
    _, _, tm, tp = _prec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_test_scan(tm, 64, tp, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_test_scan_batch(tm, 64, tp, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_test_scan_batch(tm, 64, tp, 2, 2, mesh=["cuda"])


def test_trials_bench_rehearses_on_the_cpu_and_refuses_fill(capsys):
    from qinfer_tpu_torch import trials_bench as tb

    out = tb.main(["--cpu", "--trials", "2", "--particles", "512",
                   "--steps", "12", "--interval", "4"])
    assert [r["metric"] for r in out] == [
        "trials_baseline1_aggregate_updates_per_s",
        "trials_sequential_aggregate_updates_per_s",
        "trials_batched_aggregate_updates_per_s"]
    for r in out:
        assert r["value"] > 0 and r["k3_launches"] == 0
        assert r["device_idle_share"] is None
        assert len(r["resamples_per_trial"]) == r["n_trials"]
    with pytest.raises(SystemExit, match="left out on purpose"):
        tb.main(["--cpu", "--fill", "scan"])
