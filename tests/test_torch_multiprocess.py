"""The port's particle mesh across processes, with real gloo processes on
the CPU (the counterpart of ``tests/test_multiprocess.py``, which runs
the JAX package's two processes and is marked slow).

Each launch starts W ranks of ``python -m qinfer_tpu_torch.parallel.worker
--cpu`` over a ``file://`` store in a temporary directory (no port to
clash between test workers), one thread each, with a 120 s timeout; a
rank that fails, times out or prints no ``RESULT`` fails the test. Three
launches serve the module: 2 ranks (JAX's computation and a short
precession run), 4 ranks (JAX's computation, the block exchange, one
update) and 3 ranks (the collectives, the engine's estimators and
scores, PGH, the refusals).

Tolerances, and why:

* JAX's worker computation against JAX on the conftest's virtual CPU mesh
  of the same D, from the same NumPy ensemble: the update is
  deterministic, so its log-normalization and weighted mean agree to rtol
  1e-5 (float32 sums in another order); the resample draws from another
  stream (Philox against threefry), so each package's resampled mean must
  lie within 5 σ/√n of the update's weighted mean, and its covariance
  within 5 standard errors of the update's weighted variance (the
  Liu-West kernel keeps both in expectation).
* The process mesh against the one-process mesh of the same D: the block
  exchange and the fill copy raw words, so they are equal to the bit; one
  update sums in another order, so rtol 1e-6.
* A run of PGH's adaptive loop (2¹⁴ particles x 16 steps) on 2 ranks
  against the one-process 2-shard run: the ranks' partial sums round
  otherwise than one sum over the ensemble, and each resample turns an ulp
  of weight into a changed slot now and then, after which PGH proposes
  another experiment and the runs part. So the records agree to rtol
  1e-5 only through the first resample, which both make at the same step;
  the final estimates are two draws of one law and agree within 5
  posterior standard deviations, and the resample counts within
  ``RESAMPLE_BAR`` (``chip_smoke.py``'s ``PROCESS_RESAMPLE_BAR``: at 2¹⁶
  x 256, four seeds, the counts of the two runs differed by at most 6).
* Every replicated number is the same on every rank, to the bit.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qinfer_tpu as q
from qinfer_tpu.parallel import ParticleMesh as JaxParticleMesh
from qinfer_tpu.parallel.resample import (
    DistributedLiuWestResampler as JaxDistributedLiuWestResampler)
from qinfer_tpu.smc import SMCState as JaxSMCState, _update_step_impl

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.heuristics import PGH
from qinfer_tpu_torch.parallel import DistributedLiuWestResampler, ParticleMesh
from qinfer_tpu_torch.parallel.mesh import shard_state
from qinfer_tpu_torch.parallel.resample import exchange_blocks, two_level_fill
from qinfer_tpu_torch.perf_testing import perf_test_scan
from qinfer_tpu_torch.smc import SMCState, _update_step

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_JAX = 4096
RUN = (1 << 14, 16, 0)  # particles, steps, seed of the short run
N_EXCHANGE, EXCHANGE_SEED = 4096, 5
RESAMPLE_BAR = 10


def _launch(world, tasks, store, *args):
    """Run ``world`` ranks of the worker on the CPU; each rank's RESULT
    lines, by task."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "qinfer_tpu_torch.parallel.worker",
           "--world", str(world), "--init-method", f"file://{store}/store",
           "--tasks", tasks, "--cpu", *args]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=_REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{out}"
        lines = [json.loads(ln[len("RESULT "):]) for ln in out.splitlines()
                 if ln.startswith("RESULT ")]
        assert lines, f"a rank printed no RESULT:\n{out}"
        by_task = {}
        for line in lines:
            by_task.setdefault(line["task"], []).append(line)
        results.append(by_task)
    return results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The three launches, by world size."""
    out = {}
    record = tmp_path_factory.mktemp("record")
    out["record"] = record
    for world, tasks, args in (
            (2, "jax,precession", ("--particles", str(RUN[0]), "--steps",
                                   str(RUN[1]), "--seed", str(RUN[2]),
                                   "--record", str(record))),
            (4, "jax,exchange", ("--seed", str(EXCHANGE_SEED))),
            (3, "collectives", ())):
        store = tmp_path_factory.mktemp(f"world{world}")
        out[world] = _launch(world, tasks, store, *args)
    return out


def _replicated(line):
    return {k: v for k, v in line.items()
            if k not in ("rank", "wall_s", "updates_per_s")
            and not k.startswith("local")}


def _same_on_every_rank(results, task):
    lines = [r[task] for r in results]
    for other in lines[1:]:
        assert [_replicated(a) for a in other] == [_replicated(a)
                                                   for a in lines[0]]
    return lines[0]


def _jax_computation(D):
    """JAX's worker computation on D of the conftest's virtual CPU
    devices, from the worker's NumPy ensemble (``numpy.random.
    default_rng(0)``): ``(log_norm, post-update mean, variance, fourth
    central moment, resampled mean, resampled covariance)``."""
    model = q.SimplePrecessionModel()
    pmesh = JaxParticleMesh(jax.devices()[:D])
    x_np = np.random.default_rng(0).uniform(size=(N_JAX, 1)).astype(
        np.float32)
    x = jax.device_put(jnp.asarray(x_np), pmesh.location_sharding)
    w = jax.device_put(jnp.full((N_JAX,), 1.0 / N_JAX),
                       pmesh.particle_sharding)
    state = JaxSMCState.initial(x, jax.random.key(1))._replace(
        weights=w, locations=x)
    new_state, log_norm, _ = _update_step_impl(
        model, q.LiuWestResampler(a=0.98), state, jnp.ones((1,), jnp.int32),
        {"t": jnp.full((1,), 4.3, jnp.float32)}, 0.0, 1e-10,
        check_resample=True)
    wu = np.asarray(new_state.weights, np.float64)
    xu = np.asarray(new_state.locations, np.float64)[:, 0]
    mean = float(wu @ xu)
    var = float(wu @ (xu - mean) ** 2)
    m4 = float(wu @ (xu - mean) ** 4)
    rs = JaxDistributedLiuWestResampler(pmesh.mesh, a=0.98, exchange="ring")
    w2, x2 = rs(model, jax.random.key(2), new_state.weights,
                new_state.locations)
    w2, x2 = np.asarray(w2, np.float64), np.asarray(x2, np.float64)[:, 0]
    mu2 = float(w2 @ x2)
    return float(log_norm), mean, var, m4, mu2, float(w2 @ (x2 - mu2) ** 2)


@pytest.mark.parametrize("world", [2, 4])
def test_worker_runs_the_jax_workers_computation(ranks, world):
    got = _same_on_every_rank(ranks[world], "jax")[0]
    assert got["world"] == world and got["local_rows"] == N_JAX // world
    assert got["weights_uniform"]
    log_norm, mean, var, m4, jax_mu, jax_cov = _jax_computation(world)
    np.testing.assert_allclose(got["log_norm"], log_norm, rtol=1e-5)
    np.testing.assert_allclose(got["post_update_mean"][0], mean, rtol=1e-5)
    # each resample is unbiased for the update's mean and variance
    se_mean = np.sqrt(var / N_JAX)
    se_var = np.sqrt((m4 - var ** 2) / N_JAX)
    for mu, cov in ((got["mean"][0], got["cov"][0][0]), (jax_mu, jax_cov)):
        assert abs(mu - mean) < 5 * se_mean, (mu, mean, se_mean)
        assert abs(cov - var) < 5 * se_var, (cov, var, se_var)


def test_process_mesh_exchange_and_fill_equal_the_one_process_mesh(ranks):
    """D = 4: each rank's received block and fill, by the ring and by the
    butterfly, equal the one-process mesh's row of the rank to the bit
    (the worker's inputs rebuilt here from its seed), and one update
    agrees to rtol 1e-6."""
    D, n = 4, N_EXCHANGE
    rng = np.random.default_rng(EXCHANGE_SEED)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    w = (np.exp(-((np.arange(n) - n / 5) / (n / 5)) ** 2)
         * rng.random(n)).astype(np.float32)
    w /= w.sum()
    u1 = torch.tensor(np.float32(0.37))
    u2 = torch.from_numpy(rng.uniform(0.0, 0.9, size=D).astype(np.float32))
    mesh = ParticleMesh(["cpu"] * D)
    wv, xv = mesh.shard(torch.from_numpy(w)), mesh.shard(torch.from_numpy(x))
    state = shard_state(SMCState.initial(torch.from_numpy(
        np.random.default_rng(EXCHANGE_SEED).uniform(size=(n, 1)).astype(
            np.float32))), mesh.particle_sharding)
    g = torch.Generator().manual_seed(1)
    state, log_norm, _ = _update_step(
        qt.SimplePrecessionModel(), qt.LiuWestResampler(), state,
        torch.ones((1,), dtype=torch.int32), {"t": torch.tensor([4.3])},
        0.0, 1e-10, g)
    moved = False
    for r, res in enumerate(ranks[D]):
        got = res["exchange"][0]
        for exchange in ("ring", "butterfly"):
            recv_w, recv_x = exchange_blocks(mesh, u1, wv, xv, exchange)
            fill = two_level_fill(mesh, u1, u2, wv, xv, exchange)
            mine = got[exchange]
            for key, want in (("local_w", recv_w), ("local_x", recv_x),
                              ("local_fill", fill)):
                have = np.asarray(mine[key], np.float32)
                np.testing.assert_array_equal(
                    have.view(np.int32), want[r].numpy().view(np.int32))
            moved |= not torch.equal(recv_x[r], xv[r])
        np.testing.assert_allclose(got["update"]["log_norm"], log_norm,
                                   rtol=1e-6)
        np.testing.assert_allclose(got["update"]["local_weights"],
                                   mesh.shard(state.weights)[r].numpy(),
                                   rtol=1e-6)
    assert moved  # blocks really travel between ranks


def test_short_precession_run_over_two_ranks(ranks):
    n, steps, seed = RUN
    lines = _same_on_every_rank(ranks[2], "precession")
    ring, butterfly = lines
    assert (ring["exchange"], butterfly["exchange"]) == ("ring", "butterfly")
    for res in ranks[2]:
        assert res["precession"][1]["local_ring_equals_butterfly"]
    for key in ("est", "resamples", "log_evidence", "est_record"):
        assert ring[key] == butterfly[key]
    assert ring["local_rows"] == n // 2 and ring["finite"]
    mesh = ParticleMesh(["cpu"] * 2)
    u, rec = perf_test_scan(
        qt.AcceleratedPrecessionModel(), n, qt.UniformDistribution(
            [[0.0, 1.0]]), steps, true_mps=[[0.7]], seed=seed,
        resampler=DistributedLiuWestResampler(mesh, exchange="ring"),
        sharding=mesh.particle_sharding, device="cpu")
    ess = rec["ess"].numpy()
    # the first resample leaves uniform weights: ESS n
    first = int(np.argmax(ess >= n * (1 - 1e-4)))
    assert 0 < first < steps
    np.testing.assert_allclose(ring["ess_record"][first], n, rtol=1e-4)
    np.testing.assert_allclose(ring["est_record"][:first + 1],
                               rec["est"][:first + 1, 0].numpy(), rtol=1e-5)
    sd = max(ring["posterior_sd"],
             float(u.est_covariance_mtx()[0, 0]) ** 0.5)
    assert abs(ring["est"] - float(rec["est"][-1, 0])) < 5 * sd
    assert ring["resamples"] >= 1 and u.resample_count >= 1
    assert abs(ring["resamples"] - u.resample_count) <= RESAMPLE_BAR


def test_ranks_record_their_kernel_inputs(ranks):
    """``--record``: each rank's last K1 call and first fill at its own
    shapes, the fill's output the plain twin's to the bit."""
    from qinfer_tpu_torch.ops import precession as prec
    from qinfer_tpu_torch.ops import streaming_resample as sr

    n, steps, _ = RUN
    for r in range(2):
        kept = torch.load(ranks["record"] / f"rank{r}.pt")
        omega, w, t, outcome = kept["k1"]
        assert omega.shape == w.shape == (n // 2,) and outcome in (0, 1)
        assert t > 0 and torch.isfinite(prec.fused_precession_update_plain(
            omega, w, t, outcome, normalize=False)[0]).all()
        u2, recv_w, recv_x, m, starts, x_anc = kept["fill"]
        assert u2.shape == (1,) and recv_x.shape == (1, n // 2, 1)
        assert int(m.sum()) == n // 2
        plain = sr.streaming_resample_locations_plain(m, starts, recv_x[0])
        assert torch.equal(plain.view(torch.int32),
                           x_anc.reshape(n // 2, 1).view(torch.int32))


def test_particle_mesh_spans_a_group_that_is_up(tmp_path, monkeypatch):
    """``ParticleMesh()`` after ``initialize_multihost`` spans the world,
    one shard a rank, on the entry points' default device (the CPU
    standing in for the card here); the one-process form is unchanged."""
    from qinfer_tpu_torch.parallel import initialize_multihost
    from qinfer_tpu_torch.parallel import mesh as mesh_module

    monkeypatch.setattr(mesh_module, "DEFAULT_DEVICE", "cpu")
    initialize_multihost(f"file://{tmp_path}/store", 1, 0)
    try:
        mesh = ParticleMesh()
        assert mesh.spans_processes and mesh.n_devices == 1
        assert mesh.rank == 0 and mesh.device == torch.device("cpu")
        assert ParticleMesh.from_process_group("cpu").spans_processes
        assert not ParticleMesh(["cpu"] * 2).spans_processes
    finally:
        torch.distributed.destroy_process_group()


def test_collectives_and_engine_on_three_ranks(ranks):
    D = 3
    mesh = ParticleMesh(["cpu"] * D)
    blocks = torch.stack([torch.arange(20, dtype=torch.float32).reshape(
        10, 2) + 100.0 * s for s in range(D)])
    model, prior = qt.SimplePrecessionModel(), qt.UniformDistribution(
        [[0.0, 1.0]])
    # the ensemble of the ranks' updater, whole: the same prior draw
    whole = qt.SMCUpdater(model, 10 * D, prior, device="cpu")
    whole.update(torch.tensor(1), {"t": torch.tensor([4.3])},
                 check_for_resample=False)
    cand = {"t": torch.tensor([0.5, 1.0, 2.0, 4.0])}
    want = {"mean": whole.est_mean(), "cov": whole.est_covariance_mtx(),
            "n_ess": whole.n_ess, "entropy": whole.est_entropy(),
            "log_total_likelihood": whole.log_total_likelihood,
            "eig": whole.expected_information_gain(cand),
            "risk": whole.bayes_risk(cand)}
    pgh_t = float(PGH(whole)()["t"][0])
    results = ranks[D]
    engine = _same_on_every_rank(results, "collectives")[0]["engine"]
    for r, res in enumerate(results):
        got = res["collectives"][0]
        assert got["n_devices"] == D and got["rank"] == r
        assert got["local_axis_index"] == [r]
        assert got["spans_processes"]
        # on a group, ParticleMesh() puts the rank's shard on the card:
        # without one it refuses, and never runs on the CPU unasked
        assert "no CUDA device" in got["local_implicit_mesh"]
        assert torch.equal(torch.tensor(got["psum"]), mesh.psum(blocks))
        assert torch.equal(torch.tensor(got["all_gather"]),
                           mesh.all_gather(blocks))
        for k in range(-1, D + 1):
            assert torch.equal(torch.tensor(got["local_ppermute"][str(k)]),
                               mesh.ppermute(blocks, k)[r])
        assert f"3 ranks is up, this process rank {r}" in got[
            "local_second_call"]
        assert "pad_particles(31) = 33" in got["indivisible"]
        assert got["updater_local_rows"] == 10
        # a checkpoint saved across the ranks loads back on them, one
        # saved for another mesh size is refused by name, and an estimator
        # that reads the whole cloud on the host still refuses
        assert got["reloaded"]
        assert "process_shards is 2 and this mesh spans 3" in got[
            "other_size"]
        assert "reads the whole cloud on the host" in got["host_estimator"]
    for key, value in want.items():
        np.testing.assert_allclose(engine[key], np.asarray(value),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    # the same two draws: the first over the shards' totals, the second
    # with the first particle's weight zeroed on its rank
    assert engine["pgh_t"] == pgh_t
    rows = np.asarray(engine["sample"])
    assert rows.shape == (5, 1)
    assert np.isin(rows, whole.particle_locations.numpy()).all()
