"""refit_ms (ms): the device time of the refinement pass's Newton refits in
the profiled selection, from the program's own spans (betacores_tpu_torch/
utils/profiling.py, on while a profiler runs) and the trace. The ``newton``
spans under ``refine`` (the select's own fit is not the pass's) give the
refits' calls and the device intervals of two: the eager refit's (the
first step of a recorded pass runs eagerly, and its CUDA events lie in
stream order among its operations) and the last replay's (under the
profiler a replayed graph's event nodes may fire a few operations early or
late). The device operations whose midpoint lies in an interval are one
refit; every replayed refit launches the same sequence, so the refits are
that sequence's occurrences inside the ``refine`` span, taken from
whichever of the two intervals finds more (the eager one where they tie),
and the metric is the time in which their operations ran, the mean over
those found times the calls. The profiler's per-kernel
tracing stretches the gaps between a replayed graph's kernels; the kernels'
own time it does not. The note sets the result beside the trace's device
time inside ``refine``, the layer that holds it. Nothing when the program
records no replayed ``newton`` span under ``refine`` with device times (the
CPU, or a program without the recorder)."""

from .. import trace as tracing


def _inside(ops, a: int, b: int) -> list:
    """Indices of the operations whose midpoint lies in [a, b]."""
    return [i for i, (_, s, e) in enumerate(ops) if a <= (s + e) // 2 <= b]


def _busy_ns(ops) -> int:
    return sum(e - s for s, e in tracing.busy_intervals(ops))


def _occurrences(ops, pattern: range, lo: int, hi: int, most: int) -> list:
    """Start indices in ops[lo:hi] of the names of ops[pattern], in order and
    not overlapping, at most ``most``."""
    codes: dict = {}

    def text(indices) -> str:   # one character a name
        return "".join(chr(0xE000 + codes.setdefault(ops[i][0], len(codes))) for i in indices)

    pat, hay = text(pattern), text(range(lo, hi))
    found, at = [], hay.find(pat)
    while at >= 0 and len(found) < most:
        found.append(lo + at)
        at = hay.find(pat, at + len(pat))
    return found


def read(run):
    from betacores_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or run.trace is None:
        return None
    spans = snapshot().spans
    fits = [s for s in spans if s.name == "newton" and s.parent == "refine"
            and s.device_start_ns is not None]
    layer = [s for s in spans if s.name == "refine" and s.parent is None and not s.captured
             and s.device_start_ns is not None]
    if not any(s.captured for s in fits) or len(layer) != 1:
        return None
    calls = sum(s.calls for s in fits)
    ops = run.trace.ops
    in_layer = _inside(ops, layer[0].device_start_ns, layer[0].device_end_ns)
    if not in_layer:
        return None
    best = (0,)
    for one in sorted(fits, key=lambda s: s.captured):     # the eager refit first
        refit = _inside(ops, one.device_start_ns, one.device_end_ns)
        if refit:
            pattern = range(refit[0], refit[-1] + 1)
            found = _occurrences(ops, pattern, in_layer[0], in_layer[-1] + 1, calls)
            if len(found) > best[0]:
                best = (len(found), one, pattern, found)
    if not best[0]:
        return None
    _, one, pattern, found = best
    busy = [_busy_ns(ops[a:a + len(pattern)]) for a in found]
    ms = sum(busy) / len(busy) * calls / 1e6
    layer_ms = _busy_ns(ops[in_layer[0]:in_layer[-1] + 1]) / 1e6
    run.note(f"refit_ms: {calls} newton calls under refine, {len(found)} found in the trace "
             f"({len(pattern)} operations each, from the "
             f"{'captured' if one.captured else 'eager'} refit), {ms!r} ms against {layer_ms!r} "
             f"ms of device time inside the refine span; a refit {min(busy) / 1e6!r} to "
             f"{max(busy) / 1e6!r} ms")
    return ms
