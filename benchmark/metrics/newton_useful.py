"""newton_useful (%): the share of the refinement pass's Newton iterations
in the profiled selection that did work: 100 x ``newton.iters_needed``
(the iterations entered before the fit was done, counted on the device)
over ``newton.iters_run`` (the fixed count, on the host), both counted
under the ``refine`` span (the select's own fit is not the pass's): the
program's own counters (betacores_tpu_torch/utils/profiling.py, on while a
profiler runs). Nothing when the program counts no Newton iteration in a
refinement pass."""


def read(run):
    from betacores_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    counters = snapshot().counters
    run_n = counters.get(("newton.iters_run", "refine"), 0)
    if not run_n:
        return None
    return 100.0 * counters.get(("newton.iters_needed", "refine"), 0) / run_n
