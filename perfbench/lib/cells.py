"""The benchmark as data: ``BENCHMARK.json`` names the cells, and each
configuration, traffic mix, driver and per-layer metric is a file of its
own under ``perfbench/``, found by name:

* ``configs/<config>.json``: the model, prior, resampler and counts;
* ``traffic/<cell>.json``: the cell's parameters, its driver, the limits
  of its correctness numbers;
* ``drivers/<driver>.py``: one kind of trajectory loop;
* ``metrics/<metric>.py``: one reader a per-layer metric.

Adding a cell, a configuration or a metric adds files and entries; no file
here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from .env import ROOT

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reports(metric, cell_name):
    cells = metric.get("workloads")
    return cells is None or cell_name in cells


def load_cell(name):
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files and the metrics it reports."""
    spec = benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has: "
                         f"{', '.join(sorted(cells))})")
    w = cells[name]
    config = json.loads((BENCH / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def load_module(kind, name):
    """The module ``perfbench/<kind>/<name>.py``, loaded by its path."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} file {path}")
    mod_name = f"perfbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell):
    return load_module("drivers", cell.traffic["driver"])


def metric_readers(cell):
    """``{metric name: read function}`` for the cell's per-layer metrics."""
    return {m["name"]: load_module("metrics", m["name"]).read
            for m in cell.per_layer}
