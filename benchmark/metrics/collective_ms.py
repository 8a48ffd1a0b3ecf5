"""collective_ms (ms): the device time of the NCCL kernels (the all-reduces
and all-gathers of the mesh's collectives) in rank 0's profiled selection:
the union of their intervals in the trace, per profiled selection. A NCCL
kernel runs from its launch until its peers' parts have arrived, so this
holds the ranks' waits on each other as well as the transfers. Nothing when
the trace holds no NCCL kernel (one card; a gloo world)."""

from .. import trace as tracing


def read(run):
    if run.trace is None or not run.profiled:
        return None
    ops = [op for op in run.trace.ops if "nccl" in op[0].lower()]
    if not ops:
        return None
    return tracing.busy_seconds(ops) * 1e3 / len(run.profiled)
