"""k1_roofline (%): K1's share of its roofline, the fused projected-Adam step
(ops/kernels.py::logreg_adam_step, csrc/logreg_adam_step.cu): the bound of
each launch at the cell's shapes and live rows (peaks.step_bound, through
the family's ``adam_step_bound``) summed over the profiled selections, over
the device time of the launches of ``logreg_adam_step_kernel`` in the trace.
Nothing when the trace holds no such launch, or not one per refinement
step."""

from .. import peaks

KERNEL = "logreg_adam_step_kernel"


def read(run):
    bound_of = getattr(run.family, "adam_step_bound", None)
    if bound_of is None or run.trace is None:
        return None
    times = [b - a for name, a, b in run.trace.ops if KERNEL in name]
    steps = run.route["opt_itrs"]
    if not times or len(times) != steps * len(run.profiled):
        run.note(f"k1_roofline: {len(times)} launches of {KERNEL} in the trace, "
                 f"{steps * len(run.profiled)} refinement steps profiled")
        return None
    bound_ms = sum(steps * bound_of(run.config, run.route, m, peaks)["bound_ms"]
                   for _, m in run.profiled)
    return 100.0 * bound_ms * 1e6 / sum(times)
