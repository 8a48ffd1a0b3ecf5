"""selection_mfu (%): the float32 operations the window's selections need,
counted from the cell's shapes and each selection's live buffer rows by
the family's ``selection_flops``, over the selections' time and the card's
float32 peak (peaks.py). The time is each selection's span (the CUDA
events before its select and after its refinement) outside the profiled
selections, which the profiler slows. The count does not depend on how
the program computes a selection: over several cards it is the whole
dataset's selection (the ranks' replicated fits and buffer projections
count once), over the peak of every card the run uses."""

from .. import peaks


def read(run):
    flops_of = getattr(run.family, "selection_flops", None)
    spans = run.spans("selection")
    if flops_of is None or not spans:
        return None
    flops = sum(flops_of(run.config, run.route, *run.live[k]) for k, _ in spans)
    seconds = sum(ms for _, ms in spans) / 1e3
    return 100.0 * flops / seconds / (peaks.PEAK_FLOPS * run.chips)
