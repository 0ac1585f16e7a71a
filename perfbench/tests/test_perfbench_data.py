"""The benchmark's data: ``BENCHMARK.json`` against the contract's shapes
and character sets, and a cell, configuration and metric added as new
files and entries, found with no edit to any file that is there."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from _checkout import REPO, last_line, make, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line_ok(m["layer"])
    assert len(names) == len(set(names))


def test_every_cell_is_found_by_name(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "particle_updates_per_s", "step_ms_p95"} == e2e
    configs = {c["name"] for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs
        used.add(w["config"])
        traffic = json.loads((REPO / "perfbench" / "traffic"
                              / f"{w['name']}.json").read_text())
        assert traffic["chips"] == w["chips"] and traffic["why"] == w["why"]
        assert (REPO / "perfbench" / "drivers"
                / f"{traffic['driver']}.py").is_file()
    assert used == configs
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for name in cells:
        assert any(name in m.get("workloads", cells)
                   for m in bench["per_layer"])


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_are_files_only(tmp_path):
    root = make(tmp_path)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/precession-accel.json")
                     .read_text())
    cfg["name"] = "precession-plain"
    cfg["model"] = "SimplePrecessionModel"
    (root / "perfbench/configs/precession-plain.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((root / "perfbench/traffic/precession-accel.pgh.json")
                         .read_text())
    traffic.update(particles=2048, steps=24, warmup_steps=4,
                   why="a cell added as files: the plain likelihood")
    (root / "perfbench/traffic/precession-plain.short.json").write_text(
        json.dumps(traffic))
    (root / "perfbench/metrics/resamples_per_step.py").write_text(
        "def read(cell, summaries):\n"
        "    s = summaries[0]\n"
        "    return s['counts'].get('resamples', 0) / max(s['steps'], 1)\n")
    bench["configs"].append({"name": "precession-plain",
                             "source": "https://arxiv.org/abs/1610.00336",
                             "file": "perfbench/configs/precession-plain.json",
                             "reduced": [], "why": "added in a test"})
    bench["workloads"].append({"name": "precession-plain.short",
                               "config": "precession-plain",
                               "traffic": "short", "chips": 1,
                               "why": traffic["why"]})
    bench["per_layer"].append({"name": "resamples_per_step",
                               "unit": "calls", "better": "lower",
                               "source": "program_counter",
                               "layer": "resampler",
                               "moves": "particle_updates_per_s",
                               "workloads": ["precession-plain.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out, err = run(root, "--workload", "precession-plain.short",
                       "--seed", 2 ** 31 + 5, "--seconds", 2, "--trace", 1,
                       "--cpu")
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is True
    assert line["metrics"]["resamples_per_step"]["value"] > 0
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
