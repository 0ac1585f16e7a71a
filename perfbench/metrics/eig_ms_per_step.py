"""The scorer's time a step, in ms (CUDA events around each
``score_candidates`` call the harness makes); the slowest rank."""

from perfbench.lib.readers import span_ms


def read(cell, summaries):
    return span_ms(summaries, "eig", per_step=True)
