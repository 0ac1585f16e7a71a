"""The run's result line from the summaries of its processes (one, or one
a rank)."""

from __future__ import annotations

import math

import numpy as np

from . import cells


def step_seconds(summaries):
    """Each step's latency: on cards that step together, the slowest
    rank's."""
    lists = [np.asarray(s["step_s"], dtype=np.float64) for s in summaries]
    k = min(len(v) for v in lists)
    return np.max(np.stack([v[:k] for v in lists]), axis=0)


def end_to_end(summaries):
    n = summaries[0]["n"]
    steps = summaries[0]["steps"]
    window_s = max(s["window_s"] for s in summaries)
    return {
        "particle_updates_per_s": n * steps / window_s,
        "step_ms_p95": 1e3 * float(np.percentile(step_seconds(summaries),
                                                 95)),
        "setup_s": max(s["setup_s"] for s in summaries),
    }


def _limit_ok(value, limit):
    return limit is None or (math.isfinite(value) and value <= limit)


def result(cell, summaries, args, card):
    """``(line, check lines)``: the JSON object the run prints last, and
    the lines of the numbers compared, each beside its limit."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if args.trace:
        readers = cells.metric_readers(cell)
        for m in cell.per_layer:
            if args.cpu and m["source"] == "device_trace":
                continue
            value = readers[m["name"]](cell, summaries)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    else:
        values = end_to_end(summaries)
        for m in cell.end_to_end:
            if args.cpu and m["source"] == "device_trace":
                continue
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    limits = cell.traffic["limits"]
    numbers = summaries[0]["numbers"]
    # a number is compared where the cell's traffic gives it a limit; the
    # others are readings only (a limit needs a reading that fails it)
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in sorted(numbers.items()) if name in limits}
    readings = {name: value for name, value in sorted(numbers.items())
                if name not in limits}
    missing = sorted(set(limits) - set(numbers))
    correct = all(_limit_ok(c["value"], c["limit"]) for c in checks.values())
    device = {"platform": "cpu" if args.cpu else "gpu",
              "kind": summaries[0]["device_name"],
              "count": len(summaries),
              "memory_peak_bytes": max(s["memory_peak_bytes"]
                                       for s in summaries),
              "power_limit": card,
              "tf32": summaries[0]["tf32"]}
    line = {"correct": correct,
            "attempted": summaries[0]["steps"],
            "failed": 0,
            "metrics": metrics,
            "device": device}
    if args.trace and "trace" in summaries[0]:
        traces = [s["trace"] for s in summaries]
        device["busy_s"] = float(np.mean([t["busy_s"] for t in traces]))
        device["window_s"] = float(np.mean([s["window_s"]
                                            for s in summaries]))
        line["breakdown"] = {"device_ops": traces[0]["device_ops"],
                             "idle_gaps": traces[0]["idle_gaps"]}
    if args.control and "control" in summaries[0]:
        line["control"] = {
            name: {"value": value, "limit": limits.get(name),
                   "fails": name in limits
                   and not _limit_ok(value, limits[name])}
            for name, value in sorted(summaries[0]["control"].items())}
        line["control_correct"] = all(
            not c["fails"] for c in line["control"].values())
    line["run"] = {"steps": summaries[0]["steps"],
                   "trajectories": summaries[0]["trajectories"],
                   "window_s": max(s["window_s"] for s in summaries),
                   "kinds": summaries[0]["kinds"],
                   "captured": summaries[0]["captured"],
                   "cloned": summaries[0]["cloned"],
                   "readings": readings,
                   "not_read": missing}
    if args.trace and "calls" in summaries[0]:
        line["run"]["kernels"] = {
            k: {"calls": summaries[0]["calls"][k][0],
                "bound_s": summaries[0]["calls"][k][1],
                "launches": summaries[0]["trace"]["kernels"][k][0],
                "device_s": summaries[0]["trace"]["kernels"][k][1]}
            for k in summaries[0]["calls"]}
        line["run"]["spans"] = summaries[0]["spans"]
    line["checks"] = checks
    lines = [f"{name}: {m['value']!r} {m['unit']} on {card}"
             for name, m in metrics.items()
             if "roofline" in name or "mfu" in name]
    lines += [f"check {name}: {c['value']!r} limit {c['limit']!r}"
              for name, c in checks.items()]
    return line, lines
