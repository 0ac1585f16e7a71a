"""The steps of the window that the correctness check reads.

Each step draws a key from the run's seed, ``u^(1/(i + 1))`` for the i-th
step of its trajectory (a weighted reservoir, so late steps, where the
posterior is narrowest and rounding shows most, are likelier), and the
``per_kind`` steps of each kind with the largest keys are kept. The kinds
are those the cell's driver can produce (``update``, ``resample``,
``move``): a kind that never comes would leave its reservoir open and
every step would pay for a copy. A step clones its inputs only when its
key could still enter the reservoir of one of those kinds, and its
outputs only when it enters that of its own kind, so once the reservoirs
are full few steps pay for a copy (``cloned`` counts those that did). The
keys depend on the seed and the step index alone, so every rank of a
cell that spans cards keeps the same steps."""

from __future__ import annotations

import heapq

import numpy as np

KINDS = ("update", "resample", "move")


class Capture:
    """One captured step: the driver fills ``data`` with clones of the
    step's inputs and outputs."""

    def __init__(self, key, index):
        self.key = key
        self.index = index
        self.data = {}


class Reservoir:
    def __init__(self, seed, per_kind, kinds=KINDS):
        unknown = set(kinds) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown step kinds {sorted(unknown)}")
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.per_kind = int(per_kind)
        self.heaps = {k: [] for k in kinds}
        self._count = 0
        self.cloned = 0

    def _floor(self, kind):
        heap = self.heaps[kind]
        return heap[0][0] if len(heap) >= self.per_kind else -1.0

    def want(self, step_index):
        """A :class:`Capture` for this step, or None when no reservoir
        would keep it."""
        key = float(self.rng.random()) ** (1.0 / (step_index + 1))
        self._count += 1
        if self.per_kind <= 0 or key <= min(map(self._floor, self.heaps)):
            return None
        self.cloned += 1
        return Capture(key, self._count)

    def admits(self, cap, kind):
        """``cap`` if the reservoir of ``kind`` would keep it (the driver
        then clones the step's outputs), else None."""
        if cap is None or cap.key <= self._floor(kind):
            return None
        return cap

    def commit(self, cap, kind):
        if cap is None:
            return
        heap = self.heaps[kind]
        item = (cap.key, cap.index, cap)
        if len(heap) < self.per_kind:
            heapq.heappush(heap, item)
        elif cap.key > heap[0][0]:
            heapq.heapreplace(heap, item)

    def kept(self):
        """``{kind: [Capture, ...]}`` in the order the steps ran."""
        return {k: [c for _, _, c in sorted(h, key=lambda t: t[1])]
                for k, h in self.heaps.items()}
