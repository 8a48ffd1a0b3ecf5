"""The check against a broken program (faults.py): the rest of a run, with
the timed path broken underneath, comes out not correct for each fault a
one-card cell can have; a wrong pick fails ``select_gap`` itself."""

import pytest

from benchmark import faults
from benchmark.tests.tiny import CELLS, tiny_run


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault):
    res = tiny_run(cell, seed=11, impl_factory=faults.FAULTS[fault])
    assert not res["correct"], res["readings"]
    if fault in ("altered", "duplicate"):
        got = res["checks"]["select_gap"]
        assert got["value"] > got["limit"], res["readings"]
