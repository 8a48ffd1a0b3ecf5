"""The per-layer metrics read from the program's own spans and counters
(metrics/refit_ms.py, metrics/newton_useful.py) in a traced run of each
cell on the CPU: the Newton share is read, the refit time is not (no
replayed span without a card); and the refit reader on a synthetic trace."""

import pytest

from benchmark.tests.tiny import CELLS, tiny_run


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_program_counters(cell):
    from betacores_tpu_torch.utils import profiling

    profiling.reset()
    res = tiny_run(cell, traced=True)
    metrics = res["metrics"]
    assert 0 < metrics["newton_useful"]["value"] <= 100
    assert metrics["newton_useful"]["unit"] == "%"
    assert "refit_ms" not in metrics
    assert res["correct"]


@pytest.mark.parametrize("eager_differs", [False, True])
def test_refit_ms_sums_every_refit_it_finds_in_the_trace(monkeypatch, eager_differs):
    from types import SimpleNamespace

    from benchmark.metrics import refit_ms
    from betacores_tpu_torch.utils import profiling

    fit_names = ["chol", "solve", "solve", "ls"]
    ops, t, refits = [], 0, []

    def launch(name, ns):
        nonlocal t
        ops.append((name, t, t + ns))
        t += ns + 5

    for name in fit_names:              # the select's own fit, outside refine
        launch(name, 10)
    refine_start = t
    for step in range(6):
        a = t
        for name in fit_names:
            launch(name, 100 + step)     # each refit a little longer than the last
        if step == 0 and eager_differs:
            launch("fill", 1)           # an operation the replays do not launch
        refits.append((a, t - 5))
        launch("adam", 7)
        launch("copy", 3)
    refine_end = t
    span = lambda name, parent, calls, captured, a, b: profiling.Span(  # noqa: E731
        name, parent, calls, captured, None, None, a, b, (b - a) / 1e6)
    # the first refit run eagerly, the other five by replays of a graph
    spans = [span("refine", None, 1, False, refine_start, refine_end),
             span("newton", "refine", 1, False, *refits[0]),
             span("newton", "refine", 5, True, *refits[-1])]
    monkeypatch.setattr(profiling, "snapshot", lambda: profiling.Snapshot(spans, {}))
    notes = []
    run = SimpleNamespace(trace=SimpleNamespace(ops=ops), note=notes.append)
    # every refit's own operations, not six times the last one's; where the
    # eager refit launches one more, the last replay's sequence finds them
    want = sum(4 * (100 + step) for step in range(6)) / 1e6
    assert refit_ms.read(run) == pytest.approx(want)
    source = "captured" if eager_differs else "eager"
    assert f"6 found in the trace (4 operations each, from the {source} refit)" in notes[0]
