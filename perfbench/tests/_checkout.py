"""A small checkout for the benchmark's CPU tests: ``BENCHMARK.json`` and
``perfbench/`` copied into a temporary directory, the port linked beside
them, and each cell's traffic cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

#: each cell's traffic at test size
TINY = {
    "precession-accel.pgh": dict(particles=4096, steps=48, warmup_steps=8),
    "process2q.resample-move": dict(particles=512, steps=16, warmup_steps=8,
                                    moves=2),
    "process2q.single-shot": dict(particles=512, steps=40, warmup_steps=8),
    "precession-eig.eig16-4card": dict(particles=16384, steps=12,
                                       warmup_steps=4),
}


#: Cells whose files are under ``perfbench/`` but that ``BENCHMARK.json``
#: leaves out (PERF.md, Open questions): the four-card cell, not yet run
#: on four cards, and single-shot, whose host-bound runs spread wider than
#: a bound can hold. The tests add their entries to their copy, as the PR
#: that measures each will add them to ``BENCHMARK.json``, and rehearse
#: them on the CPU (the four-card cell over gloo ranks).
PENDING = [
    {
        "config": {
            "name": "precession-eig",
            "source": "https://github.com/QInfer/python-qinfer/blob/master/src/qinfer/test_models.py",
            "file": "perfbench/configs/precession-eig.json",
            "reduced": [],
            "why": "BASELINE config 5: 10^7 particles sharded over cards, PGH and expected-information-gain scoring"
        },
        "workload": {
            "name": "precession-eig.eig16-4card",
            "config": "precession-eig",
            "traffic": "eig16-4card",
            "chips": 4,
            "why": "10^7 particles over 4 NCCL ranks (2.5e6 a card), PGH and 16 EIG candidates a step, 32-step trajectories: mesh collectives, two-level resampler, sharded scorer"
        },
        "per_layer": [
            {
                "name": "eig_ms_per_step",
                "unit": "ms",
                "better": "lower",
                "source": "program_span",
                "layer": "design",
                "moves": "particle_updates_per_s",
                "workloads": [
                    "precession-eig.eig16-4card"
                ]
            },
            {
                "name": "collective_ms_per_step",
                "unit": "ms",
                "better": "lower",
                "source": "program_counter",
                "layer": "mesh",
                "moves": "particle_updates_per_s",
                "workloads": [
                    "precession-eig.eig16-4card"
                ]
            },
            {
                "name": "collectives_per_step",
                "unit": "calls",
                "better": "lower",
                "source": "program_counter",
                "layer": "mesh",
                "moves": "particle_updates_per_s",
                "workloads": [
                    "precession-eig.eig16-4card"
                ]
            }
        ],
        "also_reported_by": [
            "launches_per_step",
            "device_idle_pct",
            "mfu_step",
            "k3_roofline_pct",
            "resample_ms"
        ]
    },
    {
        "workload": {
            "name": "process2q.single-shot",
            "config": "process2q",
            "traffic": "single-shot",
            "chips": 1,
            "why": "50 000 particles x 255 parameters, single-shot experiments, ESS every step, no moves, 1000-step trajectories: the host loop and the Born rule; moves bypassed, resampler nearly"
        },
        "also_reported_by": [
            "k3_roofline_pct",
            "k5_roofline_pct",
            "resample_ms"
        ]
    }
]


def add_pending_cells(bench):
    """``bench`` with the entries of :data:`PENDING`."""
    for entries in PENDING:
        cell = entries["workload"]["name"]
        if "config" in entries:
            bench["configs"].append(entries["config"])
        bench["workloads"].append(entries["workload"])
        bench["per_layer"].extend(entries.get("per_layer", []))
        for m in bench["per_layer"]:
            if "workloads" in m and m["name"] in entries["also_reported_by"]:
                m["workloads"].append(cell)
    return bench


def make(tmp, with_program=True, sizes=TINY):
    """The checkout at ``tmp``; the port is linked in unless
    ``with_program`` is False."""
    tmp = Path(tmp)
    bench = add_pending_cells(json.loads((REPO / "BENCHMARK.json")
                                          .read_text()))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        os.symlink(REPO / "qinfer_tpu_torch", tmp / "qinfer_tpu_torch")
    for cell, upd in (sizes or {}).items():
        path = tmp / "perfbench" / "traffic" / f"{cell}.json"
        data = json.loads(path.read_text())
        data.update(upd)
        path.write_text(json.dumps(data, indent=2))
    return tmp


def run(checkout, *args, timeout=600):
    """``perfbench/run.py`` in ``checkout``: ``(returncode, stdout,
    stderr)``, one torch thread, ``TMPDIR`` inside the checkout."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    tmp = Path(checkout) / "tmp"
    tmp.mkdir(exist_ok=True)
    env["TMPDIR"] = str(tmp)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "perfbench/run.py", *map(str, args)],
                          cwd=checkout, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def last_line(stdout):
    return json.loads(stdout.strip().splitlines()[-1])
