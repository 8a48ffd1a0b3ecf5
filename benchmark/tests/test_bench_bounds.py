"""The copied roofline bounds and the operation counts against hand-worked
values at K1's and K2's shapes, and the trace arithmetic."""

import pytest

from benchmark import harness, peaks, trace
from benchmark.families import logreg, multiclass


def test_step_bound_at_k1_shape():
    # 200 subsample rows padded to 200 + a 128-slot buffer, S = 100, d = 10,
    # 60 live slots: 2 S d^2 + 260 S (2 d + 17 + 2) + 60 S 4 + 12 * 128
    got = peaks.step_bound(328, 10, 100, 128, 260, 60, 17)
    assert got["flops"] == 20_000 + 260 * 100 * 39 + 60 * 400 + 1536 == 1_059_536
    # (328 x 11 rows, S d noise, mu, L^-1) + (w, m1, m2, sc, sclr in; 3 out)
    assert got["bytes"] == 4 * (328 * 11 + 1000 + 10 + 100) + 4 * (3 * 128 + 5 + 3 * 128) == 21_964
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(1_059_536 / 67e12 * 1e3)


def test_mc_bound_at_k2_shape():
    N = 1 << 20
    got = peaks.mc_bound(N, 100, 5, 10, True)
    assert got["flops"] == N * 100 * (5 * 27 + 6) == 14_784_921_600
    assert got["bytes"] == 4 * (N * 11 + 5000 + N * 100 + 1) == 465_587_748
    assert got["bound_ms"] == pytest.approx(0.22067, rel=1e-4)


def test_family_bounds_follow_the_cells():
    cell = harness.Cell("logreg.subsampled_select")
    got = logreg.adam_step_bound(cell.config, cell.route, 60, peaks)
    assert got["flops"] == 1_059_536 and got["bytes"] == 21_964
    mc = harness.Cell("multiclass.groups_exact")
    rows = multiclass.k2_launch_rows(mc.config, mc.route)
    assert len(rows) == 402 and rows[:2] == [1 << 20, 32768]
    full = harness.Cell("multiclass.full_select")
    assert multiclass.k2_launch_rows(full.config, full.route) == [1 << 20]


def test_operation_counts():
    # per projected value: the logistic dot product, transform and centring
    assert logreg.project_flops(1, 1, 10) == 39
    assert multiclass.project_flops(1, 1, 5, 10) == 141
    # a multiclass group selection: 201 projections of 2^20 + 32768 rows
    # dominate (3.0e12), the 13 Hessians a step over the buffer add ~0.4e12
    mc = harness.Cell("multiclass.groups_exact")
    flops = multiclass.selection_flops(mc.config, mc.route, 16384, 24576)
    assert 3.0e12 < flops < 4.5e12
    # a logistic subsampled selection: 500 steps of ~260 projected rows
    lc = harness.Cell("logreg.subsampled_select")
    assert 3e8 < logreg.selection_flops(lc.config, lc.route, 59, 60) < 3e9


def test_busy_union_and_breakdown():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("a", 41, 45)]
    assert trace.busy_intervals(ops) == [[0, 20], [30, 40], [41, 45]]
    assert trace.busy_seconds(ops) == pytest.approx(34e-9)
    data = trace.TraceData(ops, [("select", 0, 25), ("refine", 25, 50)], 50e-9)
    got = trace.breakdown(data)
    assert got["device_ops"][0] == ["b", pytest.approx(15e-9)]
    assert got["idle_gaps"][:2] == [["total.select", pytest.approx(10e-9)],
                                   ["total.refine", pytest.approx(1e-9)]]
