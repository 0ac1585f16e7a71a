"""The control: the plain reference computed in TF32 in the program's
place, on the same captured steps, must come out not correct in every
cell (the limits were set between the program's readings and the
control's on the card; here at test size on the CPU)."""

from __future__ import annotations

import pytest

from _checkout import TINY, last_line, make, run


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", list(TINY))
def test_control_is_not_correct(checkout, cell):
    rc, out, err = run(checkout, "--workload", cell, "--seed", 2 ** 31 + 99,
                       "--seconds", 3, "--trace", 0, "--cpu", "--control")
    assert rc == 0, err[-4000:]
    line = last_line(out)
    assert line["correct"] is True, line["checks"]
    assert line["control_correct"] is False, line["control"]
