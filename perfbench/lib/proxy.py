"""The traced run's thin proxy: a resampler that passes every attribute
through to the program's and times each of its calls as a span of the
``resample`` layer."""

from __future__ import annotations


class TimedResampler:
    """Stands where the program takes a resampler."""

    def __init__(self, resampler, rec):
        self._inner = resampler
        self._rec = rec

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def call_with_diagnostics(self, *args, **kwargs):
        with self._rec.span("resample"):
            return self._inner.call_with_diagnostics(*args, **kwargs)


def resampler_for(resampler, rec):
    """The proxy in a traced run, the resampler itself otherwise."""
    return TimedResampler(resampler, rec) if rec.traced else resampler
