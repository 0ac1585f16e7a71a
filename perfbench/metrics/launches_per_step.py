"""Device kernels and copies launched in the traced window, a step (the
host loop: ``SMCUpdater.update``, ``smc._update_step``); the ranks' mean."""

from perfbench.lib.readers import mean, traced


def read(cell, summaries):
    runs = traced(summaries)
    if not runs or not any(s["trace"]["launches"] for s in runs):
        return None
    return mean([s["trace"]["launches"] / max(s["steps"], 1) for s in runs])
