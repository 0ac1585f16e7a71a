"""Spans and host-read counters inside the port, off by default.

::

    from qinfer_tpu_torch import tracing

    with tracing.recording():          # the card's stream, if there is one
        for outcome, eps in data:
            updater.update(outcome, eps)
    snap = tracing.snapshot()
    tracing.reset()

The engine opens a span (:func:`span`) around each layer it enters and
each phase inside it, and counts each device→host read where it happens
(:func:`host_read`). While no recording is on, a site does one check of
the module's flag: no clock read, no CUDA event, no allocation.

While recording, each span keeps its name, its parent (the innermost span
open), its step (the ``update`` roots opened so far), its start and end on
the host's ``time.time_ns()`` (the clock ``torch.profiler``'s timestamps
are on, so a span lines up with a device trace), and its device time: a
pair of CUDA events on the current stream, folded into the name's total
once the card has passed them (``Event.query``, no wait), or the host's
duration when recording on the CPU. Recording reads nothing from the
device and never synchronizes; :func:`snapshot` waits for the last events.

:func:`snapshot` returns a plain dict:

* ``spans``: ``[name, parent, step, start_ns, end_ns]`` of every span
  closed, in the order they closed (``parent`` None for a root);
* ``totals``: ``{name: [count, device_s, host_s]}``;
* ``host_reads``: ``{site: count}``;
* ``steps``: the ``update`` roots;
* ``timer``: what timed ``device_s``.

A recording costs two CUDA events, two host clock reads and a list entry a
span. The module's state is the process's: one recording at a time.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["recording", "snapshot", "reset", "span", "host_read"]

#: the root span whose count is the step id
STEP = "update"

_on = False


class _Record:
    """The recording's state: closed spans, open spans, totals, reads and
    the CUDA events not yet folded."""

    def __init__(self):
        self.stream = None       # the stream the events time; None: host
        self.spans = []
        self.open = []           # names of the spans open, outermost first
        self.totals = {}
        self.host_reads = {}
        self.steps = 0
        self.pending = []        # (name, start event, end event)
        self.events = []         # events folded, for reuse

    def event(self):
        if self.events:
            return self.events.pop()
        return torch.cuda.Event(enable_timing=True)

    def fold(self, k):
        """Add the first ``k`` pending pairs (their end events passed) to
        their names' device seconds, and keep their events for reuse."""
        for name, a, b in self.pending[:k]:
            self.totals[name][1] += a.elapsed_time(b) / 1e3
            self.events += (a, b)
        del self.pending[:k]

    def fold_passed(self):
        done = 0
        while done < len(self.pending) and self.pending[done][2].query():
            done += 1
        if done:
            self.fold(done)


_rec = _Record()


class _Span:
    """One span of a recording."""

    __slots__ = ("name", "parent", "start_ns", "start_ev")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        rec = _rec
        self.parent = rec.open[-1] if rec.open else None
        if self.parent is None and self.name == STEP:
            rec.steps += 1
        rec.open.append(self.name)
        self.start_ev = None
        if rec.stream is not None:
            self.start_ev = rec.event()
            self.start_ev.record(rec.stream)
        self.start_ns = time.time_ns()

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        rec = _rec
        rec.open.pop()
        total = rec.totals.setdefault(self.name, [0, 0.0, 0.0])
        total[0] += 1
        total[2] += (end_ns - self.start_ns) / 1e9
        if self.start_ev is None:
            total[1] += (end_ns - self.start_ns) / 1e9
        else:
            end_ev = rec.event()
            end_ev.record(rec.stream)
            rec.pending.append((self.name, self.start_ev, end_ev))
            rec.fold_passed()
        rec.spans.append((self.name, self.parent, rec.steps, self.start_ns,
                          end_ns))


class _Off:
    """The span of every site while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name):
    """A context manager timing the phase ``name`` while recording (see the
    module); a shared one that does nothing otherwise."""
    if not _on:
        return _OFF
    return _Span(name)


def host_read(site):
    """Count one device→host read at ``site`` while recording. Call it
    where the read happens, once a read."""
    if _on:
        _rec.host_reads[site] = _rec.host_reads.get(site, 0) + 1


@contextlib.contextmanager
def recording(device=None):
    """Record spans and host reads inside the block, timing the spans on
    ``device``'s current stream (default: the card if there is one) or,
    for a CPU device, on the host's clock. What was recorded stays until
    :func:`reset`. Recordings do not nest."""
    global _on
    if _on:
        raise RuntimeError("a recording is already on")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    _rec.stream = (torch.cuda.current_stream(device)
                   if device.type == "cuda" else None)
    _on = True
    try:
        yield
    finally:
        _on = False


def snapshot():
    """What has been recorded, as a plain dict (see the module). Waits for
    the card to pass the last span's end event."""
    rec = _rec
    if rec.pending:
        rec.pending[-1][2].synchronize()
        rec.fold(len(rec.pending))
    return {
        "spans": [list(s) for s in rec.spans],
        "totals": {k: list(v) for k, v in rec.totals.items()},
        "host_reads": dict(rec.host_reads),
        "steps": rec.steps,
        "timer": ("CUDA events on the current stream"
                  if rec.stream is not None else "host clock"),
    }


def reset():
    """Drop everything recorded."""
    global _rec
    if _on:
        raise RuntimeError("reset() inside a recording")
    _rec = _Record()
