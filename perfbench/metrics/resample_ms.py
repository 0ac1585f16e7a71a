"""Mean time of one resampler call, in ms (the harness's proxy around the
resampler, CUDA events around each call); the slowest rank."""

from perfbench.lib.readers import span_ms


def read(cell, summaries):
    return span_ms(summaries, "resample")
