"""The particle mesh across processes, one rank a card: the worker's
rank-to-card map, its refusal to run NCCL on fewer cards than ranks (or
on none), the collective timer (the gloo route's collectives after its
rework, the NCCL route's pending events kept few), the ranks' first
resample and designs replayed in one process as ``chip_smoke.py`` holds
them, a one-rank group against the one-process mesh of one shard, and
the waste-free leg's layout on ``chip_smoke.py --cards 4``'s four ranks.

The ranks run as ``python -m qinfer_tpu_torch.parallel.worker --cpu``
over gloo and a ``file://`` store in the test's temporary directory, one
thread each (``test_torch_multiprocess.py``'s launcher). NCCL itself
needs cards: its tests are in ``test_torch_cuda.py``, marked ``cuda``.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

import chip_smoke
from qinfer_tpu_torch import UniformDistribution
from qinfer_tpu_torch.ops.accelerated import AcceleratedPrecessionModel
from qinfer_tpu_torch.parallel import ParticleMesh, runs, worker
from qinfer_tpu_torch.perf_testing import perf_test_scan

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the short runs whose collectives are counted (particles, steps), and
#: their counts a rank on 2 gloo ranks at the commit before the timer's
#: rework: the precession task's ring and butterfly runs, and the drift
#: leg's whole run and its run less the record's reads
PRECESSION = (4096, 12)
PRECESSION_CALLS = {"ring": 114, "butterfly": 117}
DRIFT = (4096, 20)
DRIFT_CALLS = (309, 284)


def _worker(store, *args, world=1, rank=0):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "qinfer_tpu_torch.parallel.worker",
           "--world", str(world), "--rank", str(rank), "--init-method",
           f"file://{store}/store", *args]
    return subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _launch(world, store, *args):
    """``world`` gloo ranks on the CPU: each rank's RESULT lines, by
    task."""
    procs = [_worker(store, *args, "--cpu", world=world, rank=r)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"a rank failed:\n{out}\n{err}"
        by_task = {}
        for line in out.splitlines():
            if line.startswith("RESULT "):
                line = json.loads(line[len("RESULT "):])
                by_task.setdefault(line["task"], []).append(line)
        results.append(by_task)
    return results


@pytest.mark.parametrize("cards, want", [
    (4, [0, 1, 2, 3, 0, 1, 2, 3]), (1, [0] * 8),
    (3, [0, 1, 2, 0, 1, 2, 0, 1])])
def test_rank_takes_card_rank_mod_cards(cards, want):
    assert [worker.card_of(r, cards) for r in range(8)] == want


@pytest.mark.parametrize("environ, want", [
    ({}, (5, 8)), ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}, (1, 4))])
def test_rank_on_its_host(environ, want):
    """A launcher's ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` place a rank on
    its host's cards; without them the world is one host."""
    assert worker.host_slot(5, 8, environ) == want


@pytest.mark.parametrize("world, local, cards, cpu, message", [
    (2, None, 0, False, "2 ranks and 0 cards"),
    (2, None, 1, False, "2 ranks and 1 cards"),
    (5, None, 4, False, "5 ranks and 4 cards"),
    (8, 5, 4, False, "5 ranks and 4 cards"),
    (1, None, 1, True, "1 ranks and 0 cards (--cpu asks for the CPU)")])
def test_nccl_refuses_more_ranks_than_cards(tmp_path, monkeypatch, world,
                                            local, cards, cpu, message):
    """``--backend nccl`` with more ranks on the host than cards (or
    ``--cpu``) raises ``ValueError`` naming both counts before any group
    starts: no store is written, no gloo group stands in."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if local is not None:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    argv = ["--rank", "0", "--world", str(world), "--backend", "nccl",
            "--init-method", f"file://{tmp_path}/store", "--tasks",
            "collectives"] + (["--cpu"] if cpu else [])
    with pytest.raises(ValueError, match=re.escape(
            f"NCCL takes one card a rank: {message}")):
        worker.main(argv)
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "store")


def test_nccl_without_cards_exits_with_the_message(tmp_path):
    """From the command line, on a machine without cards: a non-zero
    exit, the message, no RESULT line and no store."""
    p = _worker(tmp_path, "--backend", "nccl", "--tasks", "collectives",
                world=2)
    out, err = p.communicate(timeout=120)
    assert p.returncode != 0
    assert "NCCL takes one card a rank: 2 ranks and 0 cards" in err
    assert "RESULT" not in out
    assert not os.path.exists(tmp_path / "store")


@pytest.fixture(scope="module")
def two_ranks_run(tmp_path_factory):
    """Two gloo ranks' RESULT lines and their precession records."""
    n, steps = PRECESSION
    store = tmp_path_factory.mktemp("gloo")
    results = _launch(2, store, "--tasks", "card,precession,runs",
                      "--particles", str(n), "--steps", str(steps), "--runs",
                      f"drift:{DRIFT[0]}:{DRIFT[1]}", "--record", str(store))
    return results, [torch.load(store / f"rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def two_ranks(two_ranks_run):
    return two_ranks_run[0]


def test_gloo_collectives_keep_their_count_and_host_clock(two_ranks):
    """The collective timer's rework leaves the gloo route's collectives
    as they were: the same count a run (``PRECESSION_CALLS``,
    ``DRIFT_CALLS``), the same bits on both ranks, timed by the host's
    clock, each run's collectives taking part of its wall."""
    lines = [res["precession"] + res["runs"] for res in two_ranks]
    for res in two_ranks:
        assert res["card"][0]["local_card"] is None
        ring, butterfly, drift = res["precession"] + res["runs"]
        for line in (ring, butterfly, drift):
            assert line["collective_timer"] == "host clock"
            assert 0 < line["local_collective_s"] < line["wall_s"]
        for run in (ring, butterfly):
            assert run["collective_calls"] == PRECESSION_CALLS[
                run["exchange"]]
        assert (drift["collective_calls"],
                drift["run_collective_calls"]) == DRIFT_CALLS
    for a, b in zip(*lines):
        assert ({k: v for k, v in a.items()
                 if k not in ("rank", "wall_s", "updates_per_s")
                 and not k.startswith("local")}
                == {k: v for k, v in b.items()
                    if k not in ("rank", "wall_s", "updates_per_s")
                    and not k.startswith("local")})


class _Event:
    """A CUDA event as the collective timer uses it, each pair 1 ms
    apart; ``done`` says whether the card has passed it."""
    done = True

    def record(self, stream):
        pass

    def query(self):
        return _Event.done

    def elapsed_time(self, end):
        return 1.0

    def synchronize(self):
        _Event.done = True


def test_nccl_timer_folds_the_collectives_the_card_has_passed(monkeypatch):
    """Under NCCL the timer keeps a pair of events a collective only until
    the card has passed it: the pairs already done are summed when the
    next collective starts, with no wait, so a long run that never reads
    ``collective_seconds`` keeps few pending; reading it waits for the
    rest and sums them all."""
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: _Event())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(_Event, "done", True)
    mesh = ParticleMesh(["cpu"])
    mesh._events = True
    for _ in range(100):
        with mesh._collective("mesh.all_gather"):
            pass
        assert len(mesh._pending) == 1
    _Event.done = False  # the card falls behind: the pairs wait
    for k in range(5):
        with mesh._collective("mesh.all_gather"):
            pass
    assert len(mesh._pending) == 6
    assert mesh.collective_seconds == pytest.approx(0.105)
    assert mesh._pending == [] and mesh.collective_calls == 105


def test_ranks_first_resample_and_designs_replay_in_one_process(
        two_ranks_run):
    """What ``chip_smoke.py`` holds of the ranks' precession ring run
    against the one-process mesh of 2 shards, on the records of two gloo
    ranks: each kept step's PGH draws, replayed from the generator state
    and the ensemble over the ranks' blocks and over the one process's
    (``worker.replay_pgh``), give each run's design to the bit; the
    one-process resampler replayed on the ranks' first resample draws
    their offsets and blocks, and counts within float order
    (``chip_smoke._replayed_first_resample``)."""
    results, kept = two_ranks_run
    ring = results[0]["precession"][0]
    n, steps = PRECESSION
    mesh = ParticleMesh(["cpu"] * 2)
    model, rs = worker.recorders(mesh, steps, "ring")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        perf_test_scan(model, n, UniformDistribution([[0.0, 1.0]]), steps,
                       true_mps=[[0.7]], seed=0, resampler=rs,
                       sharding=mesh.particle_sharding, device="cpu",
                       heuristic_factory=model.heuristic)
        one = {"t_record": torch.cat(model.ts).tolist(),
               "designs": model.designs}
        kept_steps = len(model.designs)
        assert kept_steps == len(kept[0]["designs"]) >= 2
        precession = AcceleratedPrecessionModel()
        for k in range(kept_steps):
            blocks = [rank["designs"][k] for rank in kept]
            t, picks = worker.replay_pgh(precession, blocks[0][0],
                                         [b[1] for b in blocks],
                                         [b[2] for b in blocks])
            assert t == ring["t_record"][k] and len(set(picks)) == 2
            state, w, x = model.designs[k]
            assert worker.replay_pgh(precession, state, [w], [x])[0] == (
                one["t_record"][k])
        line = chip_smoke._replayed_first_resample(
            torch, torch.device("cpu"), 2, kept)
        assert "sends each shard its block to the bit" in line
        line = chip_smoke._parted_designs(torch, torch.device("cpu"), ring,
                                          one, kept, kept_steps - 1)
        assert "replayed from the same generator state" in line
    finally:
        torch.set_num_threads(threads)


def test_one_rank_group_equals_the_one_process_mesh_of_one_shard(tmp_path):
    """``chip_smoke.py``'s one-rank group (there NCCL on the card, gloo on
    the CPU here): its collectives and the engine's values equal the
    one-process mesh of one shard's to the bit; the five draws of
    ``sample`` (an inverse CDF over the ranks, multinomial in one
    process) are particles of the ensemble."""
    got = _launch(1, tmp_path, "--tasks", "collectives")[0]["collectives"][0]
    mesh = ParticleMesh(["cpu"])
    u, want = worker.engine_values(mesh)
    block = worker.fixed_blocks(mesh)
    sample = got["engine"].pop("sample")
    want.pop("sample")
    assert got["engine"] == json.loads(json.dumps(want))
    assert got["psum"] == mesh.psum(block).tolist()
    assert got["all_gather"] == mesh.all_gather(block).tolist()
    for k in (-1, 0, 1):
        assert got["local_ppermute"][str(k)] == mesh.ppermute(
            block, k)[0].tolist()
    rows = set(u.particle_locations[:, 0].tolist())
    assert len(sample) == 5 and all(r[0] in rows for r in sample)
    assert got["reloaded"] and got["collective_timer"] == "host clock"


def test_waste_free_leg_divides_into_four_ranks():
    """``--cards 4``'s waste-free leg: 51 200 particles of 8 stages run
    6400 chains, 1600 a rank, and the leg resamples through its moves on
    a mesh of 4 shards; the process phase's 50 000 (6250 chains) are
    refused there, naming the mesh size."""
    specs = dict((s[0], s[1:]) for s in chip_smoke._leg_specs(
        chip_smoke.CARDS))
    n, steps, _ = specs["drift_waste_free"]
    assert (n, steps) == chip_smoke.CARDS_WASTE_FREE == (51_200, 40)
    assert n // runs.WASTE_FREE_STAGES % chip_smoke.CARDS == 0
    assert dict((s[0], s[1:]) for s in chip_smoke._leg_specs(
        chip_smoke.PROCESSES))["drift_waste_free"][0] == 50_000
    mesh = ParticleMesh(["cpu"] * chip_smoke.CARDS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = runs.make_run(mesh, "drift_waste_free", n, 3)
        for k in range(3):
            run.step(k)
        assert run.updater.resample_count >= 1
        assert torch.isfinite(run.updater.particle_locations).all()
        run = runs.make_run(mesh, "drift_waste_free", 50_000, 3)
        with pytest.raises(ValueError, match="mesh of 4 shards runs M = "
                                             "n/P = 6250 chains"):
            for k in range(3):
                run.step(k)
    finally:
        torch.set_num_threads(threads)
