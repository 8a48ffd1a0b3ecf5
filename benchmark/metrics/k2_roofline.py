"""k2_roofline (%): K2's share of its roofline, the centred K-class
projection (ops/kernels.py::multiclass_projection,
csrc/multiclass_projection.cu): the bound of each launch at its own row
count (peaks.mc_bound, through the family's ``k2_launch_rows`` and
``k2_bound_ms``) summed over the profiled selections, over the device time
of the launches of ``multiclass_projection_kernel`` in the trace. Nothing
when the trace holds no such launch, or another number than the plan."""

from .. import peaks

KERNEL = "multiclass_projection_kernel"


def read(run):
    plan_of = getattr(run.family, "k2_launch_rows", None)
    if plan_of is None or run.trace is None:
        return None
    times = [b - a for name, a, b in run.trace.ops if KERNEL in name]
    rows = plan_of(run.config, run.route) * len(run.profiled)
    if not times or len(times) != len(rows):
        run.note(f"k2_roofline: {len(times)} launches of {KERNEL} in the trace, "
                 f"{len(rows)} in the plan")
        return None
    bound_ms = sum(run.family.k2_bound_ms(run.config, r, peaks) for r in rows)
    return 100.0 * bound_ms * 1e6 / sum(times)
