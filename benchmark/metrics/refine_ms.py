"""refine_ms (ms): the mean time of one refinement pass over the window,
from the benchmark's CUDA events recorded on the stream before and after
each ``optimize`` call (the replayed steps, the Newton refits, the
projections and the Adam updates)."""


def read(run):
    return run.span_mean("refine")
