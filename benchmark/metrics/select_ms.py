"""select_ms (ms): the mean time of one select pass over the window, from
the benchmark's CUDA events recorded on the stream before and after each
``select`` call (the build loop's select layer)."""


def read(run):
    return run.span_mean("select")
