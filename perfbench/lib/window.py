"""The measured window: trajectories back to back from the run's seed, each
step's latency on the card's clock, the spans of the layers the harness
calls into, and the window's end at the first step boundary after the
run's seconds."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class Clock:
    """Stamps on the card's clock (CUDA events on the current stream:
    each step ends with a read of its design on the host, so the card is
    idle at a boundary and an event marks it to a few microseconds); on
    the CPU, which only rehearses a run, the host's clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, a, b):
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


class Recorder:
    """A run's step boundaries, step kinds and layer spans."""

    def __init__(self, device, capture, traced=False):
        self.clock = Clock(device)
        self.capture = capture
        self.traced = traced
        self.steps = []          # (start stamp, end stamp, kind)
        self.spans = {}          # layer -> [(start, end)]
        self.host_spans = []     # (start ns, end ns, layer), host clock
        self.counts = {}
        self._start = None
        self.on = False

    def start(self):
        """The step's outcome is in hand: the step starts."""
        self._start = self.clock.stamp() if self.on else None

    def step(self, kind):
        """The step ends: its update, resample and moves are done and the
        next design has been read on the host."""
        if self.on:
            self.steps.append((self._start, self.clock.stamp(), kind))

    @contextlib.contextmanager
    def span(self, layer):
        """Time a call into ``layer`` on the card's clock, and keep its
        interval on the host's (traced runs only: the device trace's idle
        gaps are labelled by the span open on the host)."""
        if not (self.traced and self.on):
            yield
            return
        a, a_ns = self.clock.stamp(), time.time_ns()
        try:
            yield
        finally:
            self.spans.setdefault(layer, []).append((a, self.clock.stamp()))
            self.host_spans.append((a_ns, time.time_ns(), layer))

    def count(self, name, k=1):
        if self.on:
            self.counts[name] = self.counts.get(name, 0) + k

    def step_seconds(self):
        return np.asarray([self.clock.seconds(a, b) for a, b, _ in
                           self.steps], dtype=np.float64)

    def step_kinds(self):
        return [k for _, _, k in self.steps]

    def span_seconds(self):
        return {layer: np.asarray([self.clock.seconds(a, b) for a, b in v])
                for layer, v in self.spans.items()}


def trajectory_seed(seed, k):
    """The seed of the run's k-th trajectory."""
    return int(np.random.SeedSequence([int(seed), int(k)])
               .generate_state(1, dtype=np.uint32)[0])


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(driver, seed, seconds, rec, device, agree=None):
    """Trajectories 0, 1, ... back to back until ``seconds`` have passed:
    the window closes at the first step boundary after that (``agree``:
    on a cell over several ranks, at the first trajectory boundary at
    which the ranks agree the time is up, so that every rank stops at the
    same step). Returns ``(window_s, steps, trajectories)``."""
    rec.on = True
    sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    steps = 0
    done = False
    while not done:
        for _ in driver.trajectory(trajectory_seed(seed, k), rec):
            steps += 1
            if agree is None and time.perf_counter() >= deadline:
                done = True
                break
        k += 1
        late = time.perf_counter() >= deadline
        done = agree(late) if agree is not None else (done or late)
    sync(device)
    window_s = time.perf_counter() - t0
    rec.on = False
    return window_s, steps, k
