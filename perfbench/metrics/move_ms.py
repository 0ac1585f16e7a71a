"""Mean time of one resample-move event's Metropolis sweeps, in ms (CUDA
events around the moves call the harness makes)."""

from perfbench.lib.readers import span_ms


def read(cell, summaries):
    return span_ms(summaries, "moves")
