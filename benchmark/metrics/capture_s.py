"""capture_s (s): the host seconds the builder spent capturing its CUDA
graphs during set-up (``capture_stats()`` of the builder, the pass runner's
own counter); nothing when it captured none."""


def read(run):
    n_graphs, seconds = run.capture
    return seconds if n_graphs > 0 else None
