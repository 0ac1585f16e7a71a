"""The timed path broken underneath the harness, each cell at test size on
the CPU: a step that returns its state unchanged, half of the batch left
out, the outcome altered where the step takes it, a resampler that
ignores the weights or returns its input, moves that are skipped and,
across ranks, the exchange between cards left out. Each run must report
``correct`` false."""

from __future__ import annotations

import pytest

from _checkout import TINY, last_line, make, run

FAULTS = ["unchanged", "half_batch", "altered"]
#: the resampler's and the moves' faults, where the test size shows them:
#: their gaps grow as the root of the particles, and at test size only the
#: resample-move cell's, after 64 shots a step, clear their limits
LAYER_FAULTS = ["ignores_weights", "returns_input", "moves_skipped"]
CASES = ([(cell, fault) for cell in TINY for fault in FAULTS]
         + [("process2q.resample-move", f) for f in LAYER_FAULTS]
         + [("precession-eig.eig16-4card", "no_exchange")])


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(checkout, cell, fault):
    rc, out, err = run(checkout, "--workload", cell, "--seed", 4242,
                       "--seconds", 3, "--trace", 0, "--cpu",
                       "--plant",
                       f"perfbench.tests.faults:{fault}")
    assert rc == 0, err[-4000:]
    line = last_line(out)
    assert line["correct"] is False, line["checks"]
