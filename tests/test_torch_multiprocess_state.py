"""Checkpoints and trials on a particle mesh across processes: 2 gloo
ranks of ``python -m qinfer_tpu_torch.parallel.worker --cpu`` (the
launcher of ``test_torch_multiprocess.py``), started twice for the
module: the first saves three runs of ``qinfer_tpu_torch.parallel.runs``
midway (a block a rank and a manifest) and runs a batch of trials on the
trial mesh across the ranks; the second, on fresh ranks, resumes the
three runs from their checkpoints in updaters of another seed.

Tolerances: none. A resumed run continues the saved one draw for draw,
so every step's record and both ranks' weights and particles equal the
uninterrupted run's to the bit; an archive loaded into one process holds
the ranks' blocks in shard order, bit for bit; a trial runs the same
arithmetic on its rank as on the one-process trial mesh, so the gathered
records equal that mesh's to the bit. A manifest that does not match the
updater or its blocks raises ``ValueError`` naming the field.
"""

import os

import numpy as np
import pytest
import torch

import qinfer_tpu_torch as qt
from qinfer_tpu_torch.checkpoint import block_path, load_updater
from qinfer_tpu_torch.ops.accelerated import AcceleratedPrecessionModel
from qinfer_tpu_torch.parallel import ParticleMesh, runs
from qinfer_tpu_torch.parallel.worker import trial_digests
from qinfer_tpu_torch.perf_testing import perf_test_scan_batch

from test_torch_multiprocess import _launch, _replicated
from test_torch_multiprocess_moves import one_thread

N, STEPS = 4096, 20
#: the runs resumed, each saved after a step with a resample before it
#: and one after it (the coin's come at steps 0 and 6)
SAVE_AT = {"mh_compressed": 4, "time_dependent": 7, "keyed": 7}
RESUMED = tuple(SAVE_AT)
COIN_SAVE = SAVE_AT["mh_compressed"]
TRIALS = (4, 1024, 32, 7)  # trials, particles, steps, seed


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """``(first, resumed, checkpoint dir)``: each rank's lines by run (and
    the trials line), from the saving launch and the resuming one."""
    ck = tmp_path_factory.mktemp("checkpoints")
    spec = ",".join(f"{name}:{N}:{STEPS}:{SAVE_AT[name]}"
                    for name in RESUMED)
    trials = ",".join(map(str, TRIALS[:3]))
    first = _launch(2, "runs,trials", tmp_path_factory.mktemp("save"),
                    "--runs", spec, "--checkpoint", str(ck), "--trials",
                    trials, "--seed", str(TRIALS[3]))
    resumed = _launch(2, "runs", tmp_path_factory.mktemp("resume"),
                      "--runs", spec, "--checkpoint", str(ck), "--resume")

    def by_run(results):
        return [dict({line["run"]: line for line in res["runs"]},
                     trials=res.get("trials", [None])[0])
                for res in results]

    return by_run(first), by_run(resumed), ck


@pytest.mark.parametrize("name", RESUMED)
def test_resume_on_fresh_ranks_equals_the_uninterrupted_run(launches, name):
    first, resumed, _ = launches
    save = SAVE_AT[name]
    for r in range(2):
        a, b = first[r][name], resumed[r][name]
        assert b["resumed"] and not a["resumed"]
        assert _replicated(b) == _replicated(resumed[1 - r][name])
        # the state at the save is the state the resumed run starts from
        assert [b["local_w"][0][0], b["local_x"][0][0]] == [
            a["local_at_save"][0][0], a["local_at_save"][1][0]]
        for key in ("local_w", "local_x"):
            assert b[key][0] == a[key][0][save:]
        for key in ("norm", "est", "resamples", "generator"):
            assert b[key] == a[key][save:], key
        for key in ("local_final", "final_est", "final_sd", "resample_count",
                    "log_scale"):
            assert b[key] == a[key], key
        n_moves = len(a["acceptance"]) - len(b["acceptance"])
        assert b["acceptance"] == a["acceptance"][n_moves:]
        assert a["resample_count"] > a["resamples"][save - 1] >= 1


def _coin_updater(**kw):
    return qt.SMCUpdater(qt.BinomialModel(qt.CoinModel(),
                                          n_meas_max=runs.COIN[1]), N,
                         qt.UniformDistribution([[0.0, 1.0]]), seed=9,
                         n_mcmc_moves=3, mcmc_adapt=True,
                         compress_mcmc_record=True, mcmc_canonicalize=False,
                         **kw)


@pytest.mark.parametrize("layout", ["unsharded", "mesh of 4"])
def test_checkpoint_of_the_ranks_loads_into_one_process(launches, layout):
    first, _, ck = launches
    if layout == "unsharded":
        u = _coin_updater(device="cpu")
    else:
        u = _coin_updater(sharding=ParticleMesh(["cpu"] * 4)
                          .particle_sharding)
    load_updater(ck / "mh_compressed", u)
    assert u.n_particles == N and u.particle_weights.shape == (N,)
    two = ParticleMesh(["cpu"] * 2)
    saved = [first[r]["mh_compressed"]["local_at_save"] for r in range(2)]
    assert runs.checksums(two, u.particle_weights).tolist() == [
        s[0][0] for s in saved]
    assert runs.checksums(two, u.particle_locations).tolist() == [
        s[1][0] for s in saved]
    assert len(u.normalization_record) == len(u.data_record) == COIN_SAVE
    assert u._n_record == COIN_SAVE
    assert u._pool_trials == [float(runs.COIN[1] * COIN_SAVE)]
    # the one-process updater runs on from it
    u.update(torch.tensor(1), {"exp_num": torch.zeros(1, dtype=torch.int32),
                               "n_meas": torch.tensor([runs.COIN[1]])})
    assert torch.isfinite(u.est_mean()).all()


def test_a_manifest_that_does_not_match_raises(launches, tmp_path):
    _, _, ck = launches
    manifest = dict(np.load(ck / "mh_compressed.npz"))
    assert int(manifest["__process_shards"]) == 2
    for field, value, match in (
            ("__n_particles", N + 2, "n_particles is 4098"),
            ("__process_shards", 3, "process_shards is 3, but its block")):
        path = tmp_path / field
        np.savez(path, **dict(manifest, **{field: np.int64(value)}))
        for r in range(2):
            src = block_path(ck / "mh_compressed", r, 2)
            os.link(src, block_path(path, r, 2))
        u = _coin_updater(device="cpu")
        before = u.particle_locations.clone()
        with pytest.raises(ValueError, match=match):
            load_updater(path, u)
        assert torch.equal(u.particle_locations, before)
    # a one-process mesh whose shards do not divide the ensemble
    with pytest.raises(ValueError, match="pad_particles"):
        load_updater(ck / "mh_compressed",
                     qt.SMCUpdater(qt.BinomialModel(qt.CoinModel(), 2), 3,
                                   qt.UniformDistribution([[0.0, 1.0]]),
                                   sharding=ParticleMesh(["cpu"] * 3)
                                   .particle_sharding))


def test_trials_on_two_ranks_equal_the_one_process_trial_mesh(launches):
    first, _, _ = launches
    lines = [first[r]["trials"] for r in range(2)]
    assert _replicated(lines[0]) == _replicated(lines[1])
    T, n, steps, seed = TRIALS
    with one_thread():
        runner, seeds = perf_test_scan_batch(
            AcceleratedPrecessionModel(), n, qt.UniformDistribution(
                [[0.0, 1.0]]), steps, T, seed=seed,
            mesh=ParticleMesh(["cpu"] * 2, axis_name="trials"),
            return_runner=True, device="cpu")
        record = runner(seeds)
    got = lines[0]
    assert got["trials"] == T and got["collective_calls"] >= 1
    assert got["digests"] == trial_digests(record)
    assert got["resample_counts"] == runner.resample_counts
    assert got["est"] == record["est"][:, -1, 0].tolist()
    # the trials' bar (PERF.md): the median |estimate − truth| below 0.05
    assert np.median(np.abs(np.subtract(got["est"], got["true"]))) < 0.05
