"""The newton_executed reader (metrics/newton_executed.py): the share of the
refinement pass's Newton budget that ran, from the program's counters under
the ``refine`` span; the select's own fit is not counted, and a program
without the counter reads nothing. A traced run on the CPU, where every
refit is eager, reads the whole budget."""

from types import SimpleNamespace

import pytest

from benchmark.metrics import newton_executed
from benchmark.tests.tiny import tiny_run


def _read(monkeypatch, counters):
    from betacores_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: profiling.Snapshot([], counters))
    return newton_executed.read(SimpleNamespace(trace=None, note=lambda msg: None))


def test_reads_the_refinement_pass_counters(monkeypatch):
    counters = {("newton.iters_run", "refine"): 4000, ("newton.iters_executed", "refine"): 27,
                ("newton.iters_needed", "refine"): 27,
                # the select's own fit: eager, its whole budget
                ("newton.iters_run", "select"): 8, ("newton.iters_executed", "select"): 8}
    assert _read(monkeypatch, counters) == pytest.approx(100.0 * 27 / 4000)


@pytest.mark.parametrize("counters", [
    {("newton.iters_run", "refine"): 4000, ("newton.iters_needed", "refine"): 27},
    {("newton.iters_run", "select"): 8, ("newton.iters_executed", "select"): 8},
    {}])
def test_reads_nothing_without_the_counter(monkeypatch, counters):
    assert _read(monkeypatch, counters) is None


def test_a_traced_cpu_run_executes_the_whole_budget():
    from betacores_tpu_torch.utils import profiling

    profiling.reset()
    res = tiny_run("logreg.subsampled_select", traced=True)
    assert res["metrics"]["newton_executed"] == {"value": 100.0, "unit": "%"}
    assert res["correct"]
