"""``correct`` comes out false when the timed path is broken underneath: the
rest of a run, driven on the CPU at a small size (the look for a card
skipped), with each fault a training cell can have planted in the program
(``harness/faults.py``); and true on the same run without one."""
import time

import pytest

from benchmark.harness import cell, faults
from benchmark.tests.small import small_cell

CELL = "humanoid-ppo-16k"


def _run(fault):
    code, out = cell.run(small_cell(CELL), 2**31 + 17, 0.2, False, time.time(),
                         device="cpu", fault=fault)
    assert code == 0
    return out


def test_sound_run_is_correct():
    out = _run(None)
    assert out["correct"] and list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_caught(fault):
    out = _run(fault)
    assert not out["correct"], out["checks"]
