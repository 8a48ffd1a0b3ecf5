"""newton_executed (%): the share of the refinement pass's Newton iteration
budget in the profiled selection that the card ran: 100 x
``newton.iters_executed`` (each iteration that ran: the whole budget of an
eager refit, one a conditional body that a captured refit's replay ran,
counted on the device) over ``newton.iters_run`` (the budget, on the host),
both counted under the ``refine`` span (the select's own fit is not the
pass's): the program's own counters (betacores_tpu_torch/utils/
profiling.py, on while a profiler runs). Beside ``newton_useful`` it shows
whether the refit stops where it is done (equal) or runs its budget out
(100). Nothing when the program counts no executed Newton iteration in a
refinement pass."""


def read(run):
    from betacores_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    counters = snapshot().counters
    run_n = counters.get(("newton.iters_run", "refine"), 0)
    executed = counters.get(("newton.iters_executed", "refine"))
    if not run_n or executed is None:
        return None
    return 100.0 * executed / run_n
