"""``tomography_bench``'s resample-move path against the JAX package.

One-qubit process tomography (15 parameters, embedded d = 8) at 1000
particles and 100 steps, 16 shots an experiment and 2 adaptive random-walk
sweeps after every resample (``--shots 16 --moves 2 --adapt``), three
seeds in each package. Threefry and Philox never match, so the comparison
is statistical: the port's mean fidelity lies within 0.03 of the JAX
loop's (their per-seed spread is ~0.005), and every port run beats both
the prior mean and the single-shot loop of the same seed. The JAX side
runs the JAX benchmark's step (``benchmarks/tomography_bench.py``: the
validity-tolerant Liu-West resampler, since the moves re-project, and the
moves on the fixed 16-pair pool's sufficient statistics) with its jitted
update step and move kernel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu as q
import qinfer_tpu.tomography as jtomo
from qinfer_tpu.rejuvenation import (initial_log_scale,
                                     mcmc_rejuvenate_binomial_adaptive_jit)
from qinfer_tpu.resamplers import LiuWestResampler as JaxLiuWest
from qinfer_tpu.smc import SMCState as JaxSMCState
from qinfer_tpu.smc import _update_step as jax_update_step

from qinfer_tpu_torch import tomography_bench as tb

N, STEPS, SHOTS, MOVES = 1000, 100, 16, 2


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


def _process_truth():
    J = np.zeros((4, 4), np.complex64)
    for a in range(2):
        for b in range(2):
            E = np.zeros((2, 2), np.complex64)
            E[a, b] = 1
            J += np.kron(E, E)
    return (0.75 * J + 0.25 * np.kron(np.eye(2), np.eye(2) / 2)) / 2


def _jax_moves_fidelity(seed):
    base = jtomo.ProcessTomographyModel(jtomo.pauli_basis(2),
                                        jtomo.pauli_basis(1))
    model = q.BinomialModel(base, n_meas_max=SHOTS)
    prior = jtomo.BCSZChoiDistribution(base.basis)
    resampler = JaxLiuWest(a=0.98, maxiter=4, canonicalize=False)
    fid = _fiducials(jtomo.pauli_basis(1))
    pool = {"prep": jnp.asarray(np.repeat(fid, 4, axis=0)),
            "meas": jnp.asarray(np.tile(fid, (4, 1)))}
    true_rho = _process_truth()
    true = jnp.asarray(np.asarray(base.states_to_modelparams(
        true_rho[None])))
    key = jax.random.key(seed)
    st = JaxSMCState.initial(prior.sample(jax.random.fold_in(key, 1), N),
                             jax.random.fold_in(key, 2))
    succ = np.zeros(16, np.int32)
    trials = np.zeros(16, np.int32)
    ls = jnp.float32(initial_log_scale(base.n_modelparams, "rwm"))
    t = jnp.int32(0)
    simulate = jax.jit(lambda k, e: model.simulate_experiment(k, true, e))
    rng = np.random.default_rng(seed)
    for k in range(STEPS):
        i, j = rng.integers(0, 4, 2)
        eps = {"prep": jnp.asarray(fid[i][None]),
               "meas": jnp.asarray(fid[j][None]),
               "n_meas": jnp.asarray([SHOTS], jnp.int32)}
        o = simulate(jax.random.fold_in(key, 100 + k), eps).reshape(-1)[:1]
        st, _, _ = jax_update_step(model, resampler, st, o, eps, 0.5, 1e-10)
        succ[4 * i + j] += int(o[0])
        trials[4 * i + j] += SHOTS
        if bool(st.just_resampled):
            x, _, ls, t = mcmc_rejuvenate_binomial_adaptive_jit(
                model, prior, jax.random.fold_in(key, 10_000 + k),
                st.locations, jnp.asarray(succ), jnp.asarray(trials), pool,
                n_moves=MOVES, log_scale=ls, adapt_t=t, method="rwm",
                canonicalize=True, adapt=True)
            st = st._replace(locations=x)
    est = np.asarray(st.weights) @ np.asarray(st.locations)
    return float(np.asarray(base.fidelity_with(est[None], true_rho))[0])


def test_moves_loop_fidelity_is_in_the_jax_band():
    cpu = torch.device("cpu")
    cfg = tb.make_config("process", cpu, 1)
    opts = tb.Moves(shots=SHOTS, moves=MOVES, adapt=True)
    port = [tb.timed_run(cfg, N, STEPS, seed, cpu, opts) for seed in range(3)]
    single = [tb.timed_run(cfg, N, STEPS, seed, cpu) for seed in range(3)]
    jax_f = [_jax_moves_fidelity(seed) for seed in range(3)]
    port_f = [r["fidelity"] for r in port]
    for r, s in zip(port, single):
        assert r["fidelity"] > r["prior_fidelity"] + 0.1
        assert r["fidelity"] > s["fidelity"]
        assert r["move_calls"] == r["state"].resample_count >= 1
        assert 0.1 < r["mean_move_acceptance"] < 0.5
        assert np.isfinite(r["final_log_scale"])
        assert bool(torch.isfinite(r["state"].locations).all())
        # the moves re-project, the resampler does not
        assert r["projections"] <= r["move_calls"]
    assert abs(np.mean(port_f) - np.mean(jax_f)) < 0.03, (port_f, jax_f)


_REFUSED = [
    ("--diffusive --shots 4", "--shots requires"),
    ("--diffusive --moves 2", "--moves requires a time-independent"),
    ("--process --project-every 2", "--project-every requires"),
    ("--process --moves 2 --waste-free 4 --project-every 2",
     "--project-every requires"),
    ("--process --moves 2 --adapt --record full",
     "require the sufficient-statistic"),
    ("--process --moves 2 --mcmc-method mala --waste-free 4",
     "not --waste-free"),
]


@pytest.mark.parametrize("flags,message", _REFUSED)
def test_bench_refuses_what_the_jax_bench_refuses(flags, message):
    args = tb.parse_args(flags.split() + ["--cpu"])
    mode = "process" if args.process else "diffusive"
    cfg = tb.make_config(mode, torch.device("cpu"), 1)
    with pytest.raises(SystemExit, match=message):
        tb.moves_from_args(args).check(cfg)


@pytest.mark.parametrize("moves", [0, 2])
@pytest.mark.parametrize("no_move_canon", [False, True])
@pytest.mark.parametrize("project_every", [0, 2])
@pytest.mark.parametrize("strict", [False, True])
def test_bench_resampler_keeps_one_strict_projection(
        moves, no_move_canon, project_every, strict):
    """The JAX benchmark's rule (``benchmarks/tomography_bench.py``): the
    resampler projects unless the moves do or a periodic projection
    does."""
    opts = tb.Moves(moves=moves, no_move_canonicalize=no_move_canon,
                    project_every=project_every,
                    strict_resample_canonicalize=strict)
    want = (moves == 0 or (no_move_canon and project_every == 0) or strict)
    assert opts.resampler().canonicalize == want
    assert opts.resampler().maxiter == 4 and opts.resampler().a == 0.98


def test_bench_flags_parse_into_moves():
    args = tb.parse_args(
        "--process --process-qubits 2 --particles 50000 --shots 64 --moves 8"
        " --adapt --target-accept 0.14 --interval 4 --no-move-canonicalize"
        .split())
    opts = tb.moves_from_args(args)
    assert opts == tb.Moves(shots=64, moves=8, adapt=True,
                            target_accept=0.14, interval=4,
                            no_move_canonicalize=True)
    assert opts.adaptive and opts.proposal_scale is None
    assert opts.resampler().canonicalize  # one strict projection an event
