"""The window keeps the states of the compared selections only: a fixed
number, whatever the number of selections it completes."""

import random
import time

import pytest
import torch

from benchmark import compare, harness
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("count", [1, 2, 3, 5])
@pytest.mark.parametrize("offered", [1, 2, 3, 4, 50])
def test_kept_holds_the_first_the_latest_and_a_draw_between(count, offered):
    kept = compare.Kept(count, random.Random(offered))
    for j in range(offered):
        kept.offer(j, f"state {j}")
    got = [j for j, _ in kept.items()]
    assert len(got) == min(count, offered) and got == sorted(set(got))
    assert got[0] == 0
    if count >= 2:
        assert got[-1] == offered - 1


def test_the_draw_between_reaches_every_selection():
    seen = set()
    for seed in range(400):
        kept = compare.Kept(3, random.Random(seed))
        for j in range(10):
            kept.offer(j, None)
        seen |= {j for j, _ in kept.items()} - {0, 9}
    assert seen == set(range(1, 9))


def test_the_window_keeps_a_fixed_number_of_states():
    cell = tiny_cell("logreg.subsampled_select")
    device = torch.device("cpu")
    inputs = harness.make_inputs(cell, 5, device)
    impl = harness.PortImpl(cell, inputs, device)
    window = harness.drive(cell, impl, 1.0, device, False, seed=5,
                           min_selections=2 * cell.route["selections"])
    assert window.n >= 2 * cell.route["selections"]
    assert [j for j, _ in window.kept][0] == 0
    assert len(window.kept) == cell.traffic["compare_selections"]
    assert window.kept[-1][0] == cell.route["selections"] - 1
    # the live counts of a restarted build repeat the first build's
    M = cell.route["selections"]
    assert window.live[M:2 * M] == window.live[:M]
    assert window.live[0] == (0, 1)
