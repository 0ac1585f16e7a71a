"""What the per-layer metrics' readers share. A reader returns None where
its run has nothing to read (no trace, no such span or kernel), and the
metric is then left out of the line."""

from __future__ import annotations

import numpy as np

from . import roofline


def traced(summaries):
    return [s for s in summaries if "trace" in s]


def kernel_roofline_pct(summaries, key):
    """Σ the calls' least times ÷ Σ the kernel's device time, in %, over
    the ranks: None unless the calls observed at the op's boundary are
    the kernel's launches in the trace, one for one."""
    bound_s = device_s = 0.0
    for s in traced(summaries):
        calls, bound = s.get("calls", {}).get(key, [0, 0.0])
        events, seconds = s["trace"]["kernels"].get(key, [0, 0.0])
        if calls != events:
            return None
        bound_s += bound
        device_s += seconds
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s


def span_ms(summaries, layer, per_step=False):
    """A layer's span time in ms, the slowest rank's: a call's mean, or
    the window's total over its steps."""
    values = []
    for s in summaries:
        count, seconds = s.get("spans", {}).get(layer, [0, 0.0])
        if count == 0:
            continue
        values.append(1e3 * seconds / (s["steps"] if per_step else count))
    return max(values) if values else None


def least_step_seconds(cfg, summary):
    """The steps' least time on the card from the configuration's counts
    (bytes and operations a particle of each stage): every step updates
    and designs, a resample step resamples too, a move step also moves."""
    counts = cfg["counts"]
    n = summary["n_local"]
    kinds = summary["kinds"]
    stages = {"update": ["update", "design"],
              "resample": ["update", "design", "resample"],
              "move": ["update", "design", "resample", "move"]}
    total = 0.0
    for kind, k in kinds.items():
        nbytes = sum(counts[st]["bytes"] for st in stages[kind]) * n
        ops = sum(counts[st]["ops"] for st in stages[kind]) * n
        total += k * roofline.bound(nbytes, ops)[0]
    return total


def mean(values):
    values = [v for v in values if v is not None]
    return float(np.mean(values)) if values else None
