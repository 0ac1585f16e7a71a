"""The whole step's share of the card's peak, in %: the steps' least time
(the larger of operations ÷ 33.5e12/s and bytes ÷ 3.35e12/s, from the
configuration's counts) over their measured time; the ranks' mean."""

from perfbench.lib.readers import least_step_seconds, mean, traced


def read(cell, summaries):
    values = []
    for s in traced(summaries):
        spent = sum(s["step_s"])
        if spent > 0:
            values.append(100.0 * least_step_seconds(cell.config, s) / spent)
    return mean(values)
