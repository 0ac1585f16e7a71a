"""The share of the traced window in which no kernel or copy ran on the
card (1 − the union of device-busy intervals ÷ the window), in %, the
ranks' mean."""

from perfbench.lib.readers import mean, traced


def read(cell, summaries):
    runs = [s for s in traced(summaries) if s["trace"]["busy_s"] > 0]
    if not runs:
        return None
    return mean([100.0 * (1.0 - s["trace"]["busy_s"] / s["window_s"])
                 for s in runs])
