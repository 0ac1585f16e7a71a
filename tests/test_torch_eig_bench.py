"""The experiment-design slice end to end at small size, on the CPU.

* ``tomography_bench --eig``: one-qubit process tomography at 16 shots
  with 2 adaptive sweeps after each resample, and plain one-qubit state
  tomography, 2000 particles, 100 steps, the egreedy policy rescoring
  every 4th step and after each resample. The pool's scores on the run's
  final state equal the JAX package's ``_expected_information_gain`` on
  the same state (rtol 1e-5, atol 1e-6, float32), and the run's rescore
  count equals the JAX benchmark's carry rule (``idx % K == 0`` or the
  previous step resampled) applied to the run's own resample steps. Each
  run beats the prior mean's fidelity.
* ``expdesign_bench`` (BASELINE config 5) at 4096 particles, 32 steps, 16
  candidates, unchunked and 4 at a time: the posterior mean within 0.05
  of the true 0.7, the same in both.
* ``horizon_bench`` at 300 particles: one row a variant, the fidelity
  read along the run.
* The new entry points refuse to run without a card unless asked for
  the CPU.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import qinfer_tpu.tomography as jtomo
from qinfer_tpu.smc import _expected_information_gain as jax_eig

from qinfer_tpu_torch import expdesign_bench as eb
from qinfer_tpu_torch import tomography_bench as tb

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_model(mode):
    if mode == "process":
        return jtomo.ProcessTomographyModel(jtomo.pauli_basis(2),
                                            jtomo.pauli_basis(1))
    return jtomo.TomographyModel(jtomo.pauli_basis(1))


def _jax_rescores(n_steps, interval, resample_steps):
    """The JAX benchmark's carry rule: rescore at ``idx % K == 0`` or when
    the state the step starts from just resampled."""
    just = set(resample_steps)
    return sum(1 for idx in range(n_steps)
               if idx % interval == 0 or (idx - 1) in just)


@pytest.mark.parametrize("mode, flags", [
    ("process", "--process --process-qubits 1 --shots 16 --moves 2 "
                "--adapt"),
    ("state", ""),
])
def test_eig_bench_scores_and_rescores_match_jax(mode, flags):
    args = tb.parse_args((flags + " --eig --eig-policy egreedy "
                          "--eig-interval 4 --cpu").split())
    design = tb.design_from_args(args)
    assert design == tb.Design(policy="egreedy", epsilon=0.25, interval=4)
    cfg = tb.make_config(mode, CPU, 1, 1, design=design)
    r = tb.timed_run(cfg, 2000, 100, 3, CPU, tb.moves_from_args(args))
    st = r["state"]
    assert r["fidelity"] > r["prior_fidelity"]
    assert st.resample_count == len(r["resample_steps"]) > 0
    if args.moves:
        assert r["move_calls"] == st.resample_count
    assert r["n_rescores"] == _jax_rescores(100, 4, r["resample_steps"])
    assert r["n_rescores"] < 100

    w, x = st.weights.numpy(), st.locations.numpy()
    got = cfg.pool_scores(st.weights, st.locations)
    pool = {k: jnp.asarray(v.numpy()) for k, v in cfg.pool_eps.items()}
    n_pool = next(iter(pool.values())).shape[0]
    want = jax_eig(_jax_model(mode), jnp.asarray(w), jnp.asarray(x),
                   jnp.arange(2), jnp.ones((2, n_pool)), pool)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_eig_interval_one_rescores_every_step_and_greedy_picks_the_argmax():
    cfg = tb.make_config("state", CPU, qubits=1, design=tb.Design())
    r = tb.timed_run(cfg, 500, 20, 0, CPU)
    assert r["n_rescores"] == 20
    st = r["state"]
    eps, pick = cfg.propose(None, 20, st.weights, st.locations)
    scores = cfg.pool_scores(st.weights, st.locations)
    assert int(pick) == int(torch.argmax(scores))
    assert torch.equal(eps["meas"], cfg.pool_eps["meas"][pick])
    assert tb.timed_run(tb.make_config("state", CPU, qubits=1), 500, 20, 0,
                        CPU)["n_rescores"] is None


def test_eig_is_refused_on_the_diffusive_path():
    with pytest.raises(SystemExit, match="candidate pool"):
        tb.make_config("diffusive", CPU, design=tb.Design())
    args = tb.parse_args("--diffusive --eig --cpu".split())
    with pytest.raises(SystemExit, match="candidate pool"):
        tb.make_config("diffusive", CPU, design=tb.design_from_args(args))


@pytest.mark.parametrize("chunk", [0, 4])
def test_expdesign_bench_recovers_omega(chunk):
    r = eb.run_bench(4096, 32, 16, chunk, device="cpu")
    assert r["ok"] and abs(r["posterior_mean"] - 0.7) < 0.05
    assert r["resamples"] > 0 and r["peak_memory_bytes"] is None
    assert r["state"].locations.shape == (4096, 1)
    if chunk:
        want = eb.run_bench(4096, 32, 16, 0, device="cpu")
        assert abs(r["posterior_mean"] - want["posterior_mean"]) < 1e-3


def test_expdesign_bench_records_each_step():
    r = eb.run_bench(2048, 12, 4, 0, device="cpu", record=True)
    plain = eb.run_bench(2048, 12, 4, 0, device="cpu")
    assert r["posterior_mean"] == plain["posterior_mean"]
    assert len(r["t_record"]) == len(r["mean_record"]) == 12
    assert r["mean_record"][-1] == r["posterior_mean"]
    assert r["resample_record"][-1] == r["resamples"] >= 1
    assert r["resample_record"] == sorted(r["resample_record"])
    x = r["state"].locations[:, 0].double()
    w = r["state"].weights.double()
    sd = float(w @ (x - w @ x) ** 2) ** 0.5
    np.testing.assert_allclose(r["posterior_sd"], sd, rtol=1e-4)


def test_expdesign_bench_refuses_a_chunk_that_does_not_divide():
    with pytest.raises(ValueError, match="multiple"):
        eb.run_bench(256, 2, 16, 5, device="cpu")
    with pytest.raises(SystemExit, match="multiple"):
        eb.main(["--cpu", "--virtual", "8", "--particles", "256",
                 "--chunk", "5"])


def test_new_entry_points_need_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eb.run_bench(256, 2, 4)
    assert eb.main(["--particles", "256", "--steps", "2"]) == 1
    assert tb.main("--process --process-qubits 1 --particles 100 --steps 2 "
                   "--eig".split()) == 1
    assert "pass --cpu" in capsys.readouterr().err
    assert eb.main("--cpu --particles 256 --steps 4 --candidates 4".split()
                   ) in (0, 1)
    assert '"device": "cpu"' in capsys.readouterr().out


def test_horizon_bench_reads_the_fidelity_along_the_run(capsys):
    from qinfer_tpu_torch import horizon_bench as hb

    assert hb.main("--cpu --particles 300 --steps 8 --steps-eig1 4 --every 4 "
                   "--seeds 1 --process-qubits 1".split()) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["variant"] for r in rows] == ["noeig", "eig4", "eig1"]
    assert [sorted(r["fid"], key=int) for r in rows] == [
        ["4", "8"], ["4", "8"], ["4"]]
    assert all(0.0 < f <= 1.0 for r in rows for f in r["fid"].values())
    if not torch.cuda.is_available():
        assert hb.main(["--seeds", "1"]) == 1
