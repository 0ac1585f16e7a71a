"""Kernel K5's share of its roofline, in %: Σ its calls' least time ÷ Σ
its device time in the trace."""

from perfbench.lib.readers import kernel_roofline_pct


def read(cell, summaries):
    return kernel_roofline_pct(summaries, "K5")
