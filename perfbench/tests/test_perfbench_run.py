"""Runs of the harness on the CPU at test size: each cell's driver against
its plain reference, the last line's keys, the refusals (no card, no
program), and the whole-name check that nothing of JAX or the JAX package
loads on any cell's path. The ``cuda`` test runs a cell on the card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from _checkout import REPO, TINY, last_line, make, run

CELLS = list(TINY)
ARGS = ("--seconds", 3, "--cpu")


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_its_reference(checkout, cell):
    rc, out, err = run(checkout, "--workload", cell, "--seed", 2 ** 31 + 17,
                       "--trace", 0, "--seconds", 3,
                       "--cpu")
    assert rc == 0, err[-4000:]
    line = last_line(out)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert sum(line["run"]["captured"].values()) > 0
    # every number compared is on standard error's last lines too
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {name}" for name in line["checks"]]


def test_last_line_keys(checkout):
    rc, out, err = run(checkout, "--workload", "precession-accel.pgh",
                       "--seed", 99, "--trace", 1, *ARGS)
    assert rc == 0, err[-4000:]
    line = last_line(out)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(line["device"])
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    # a CPU run writes no device metric
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    device = {m["name"] for m in bench["per_layer"] + bench["end_to_end"]
              if m["source"] == "device_trace"}
    assert not device & set(line["metrics"])
    assert line["metrics"]["resample_ms"]["value"] > 0


def test_no_card_exits_nonzero(checkout):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc, out, err = run(checkout, "--workload", "precession-accel.pgh",
                       "--seed", 1, "--seconds", 1, "--trace", 0)
    assert rc != 0 and out.strip() == ""
    assert "no CUDA device" in err


def test_without_the_program_exits_nonzero(tmp_path):
    bare = make(tmp_path, with_program=False)
    rc, out, err = run(bare, "--workload", "precession-accel.pgh", "--seed",
                       1, *ARGS)
    assert rc != 0 and out.strip() == ""


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(REPO))
    from perfbench.lib.env import forbidden_modules

    assert forbidden_modules({"qinfer_tpu_torch": 0,
                              "qinfer_tpu_torch.smc": 0,
                              "jaxtyping": 0, "benchmarks_x": 0}) == []
    assert forbidden_modules({"qinfer_tpu": 0, "qinfer_tpu.smc": 0,
                              "jax.numpy": 0, "flax": 0, "benchmarks": 0,
                              "torch": 0}) == [
        "benchmarks", "flax", "jax.numpy", "qinfer_tpu", "qinfer_tpu.smc"]


def test_no_cell_path_loads_jax_or_the_jax_package(checkout):
    """Every module a run of each cell loads, by whole top-level name:
    the harness, the drivers, the reference and the port."""
    code = (
        "import sys, runpy\n"
        "sys.argv = ['perfbench/run.py']\n"
        "sys.path.insert(0, '.')\n"
        "from perfbench.lib import cells, env\n"
        "env.prepare()\n"
        "import perfbench.run\n"
        "for name in %r:\n"
        "    cell = cells.load_cell(name)\n"
        "    cells.driver(cell); cells.metric_readers(cell)\n"
        "import perfbench.lib.trace, perfbench.lib.ranks\n"
        "import perfbench.reference.tomography, perfbench.reference.precession\n"
        "print(env.forbidden_modules())\n" % (CELLS,))
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cell_on_the_card(card, tmp_path):
    root = make(tmp_path, sizes=None)
    rc, out, err = run(root, "--workload", "precession-accel.pgh", "--seed",
                       2 ** 31 + 3, "--seconds", 2, "--trace", 0,
                       timeout=1200)
    assert rc == 0, err[-4000:]
    line = last_line(out)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"particle_updates_per_s", "step_ms_p95",
                                    "setup_s"}


def test_reservoir_clones_few_steps_once_full():
    """Only the kinds a cell produces hold the reservoirs open: with a
    rare kind among them, a window of long trajectories still clones few
    of its steps."""
    sys.path.insert(0, str(REPO))
    from perfbench.lib.capture import Reservoir

    res = Reservoir(2 ** 31 + 1, 3, ("update", "resample"))
    rng = __import__("random").Random(5)
    steps = 0
    for _ in range(20):
        for i in range(1000):
            cap = res.want(i)
            kind = "resample" if rng.random() < 0.015 else "update"
            res.commit(res.admits(cap, kind), kind)
            steps += 1
    assert res.cloned < 0.1 * steps
    assert {k: len(v) for k, v in res.kept().items()} == {"update": 3,
                                                         "resample": 3}
