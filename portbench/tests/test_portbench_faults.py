"""The run with its timed path broken underneath: `correct` comes out
false, once for each fault the cell can have (one card: no exchange
between chips to leave out)."""

import pytest

from portbench.tests.smallcells import cells_of, run_small

FAULTS = {
    "sustained_rollouts": ["step_unchanged", "half_lanes", "answer_altered"],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for d, fs in FAULTS.items()
                                        for c in cells_of(d) for f in fs])
def test_fault_makes_the_run_not_correct(cell, fault):
    result, checks, _ = run_small(cell, fault=fault)
    assert result["correct"] is False, checks
