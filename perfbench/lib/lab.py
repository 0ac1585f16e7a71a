"""The lab: the outcomes of the experiments the drivers run, drawn on the
host from the trajectory's seed at the truth, as a lab hands its outcomes
to the experimenter. The program sees only the outcome."""

from __future__ import annotations

import math

import numpy as np


def pr0(omega, t):
    """The precession model's Pr(0 | ω; t) = cos²(ω·t/2), in float64."""
    return math.cos(0.5 * float(omega) * float(t)) ** 2


class Lab:
    def __init__(self, seed):
        self.rng = np.random.default_rng([int(seed), 0x1AB])

    def bit(self, p0):
        """0 with probability ``p0``, else 1."""
        return 0 if self.rng.random() < p0 else 1

    def count(self, p0, shots):
        """Successes (outcome 0) of ``shots`` shots; a bit when ``shots``
        is 0 (0 with probability ``p0``)."""
        if shots <= 0:
            return self.bit(p0)
        return int(self.rng.binomial(int(shots), float(p0)))
