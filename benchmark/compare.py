"""The comparison that decides ``correct``.

While the window runs, ``Kept`` holds the selections the check compares:
the first of the build, which starts from the empty state the benchmark
made; the latest of the first build, whose buffer is the fullest; and,
where more are compared, ones drawn from the seed between them by a
reservoir draw. It holds that many states however many selections the
window completes, so the card memory it takes does not grow with the
program's speed. After the window the plain reference (reference.py,
float64) works each kept selection out again from the state the program
started it from and with the same draws, and three numbers are read:

- ``select_gap``: 0 where the program installed what the reference's
  select installs (the same row or group, in the same slots, the row's
  values copied exactly, nothing else moved); where the two differ, how far
  the program's choice scores below the reference's best (or how far the
  decision to install or not lay on the other side of the best buffer
  point's score), as a share of the distance from the best candidate's
  score to the median candidate's: candidates that score alike, as groups
  of alike rows do, then still tell a near tie from a wrong pick. A change
  to slots it must not touch, a pick outside the candidates, or an install
  the reference forbids (a row or group already in the buffer, no room)
  reads inf.
- ``weight_gap``: the widest gap, over the live slots, between the
  program's refined weight and the reference's from the program's selected
  state, each against the larger of the reference's weight and the median
  live weight (so that a weight near 0 does not divide by 0); and
  ``weight_median_gap``, the median of those per-slot gaps. A refinement
  that moves the buffer's rows, indices, count or groups, or a weight in a
  padding slot, reads inf.

A cell compares the numbers its limits file (``limits/<cell>.json``)
names: ``select_gap``, the worst over every compared selection;
``start_gap``, the worse of ``select_gap`` and ``weight_gap`` on the first
selection; and ``later_gap``, the worst ``weight_median_gap`` over the
later compared selections. The run is correct when every number is finite
and within its limit.
"""

from __future__ import annotations

import math

import torch

from .reference import RefState, SelectOutcome

TINY = 1e-30


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.to(b.dtype), b))


def _unchanged(before: RefState, after: RefState, upto: int) -> bool:
    """The first ``upto`` slots and the padding past ``after.m`` equal."""
    return (_same(after.idcs[:upto], before.idcs[:upto])
            and _same(after.pts[:upto], before.pts[:upto])
            and _same(after.wts[:upto], before.wts[:upto])
            and _same(after.idcs[after.m:], before.idcs[after.m:]))


def select_gap(out: SelectOutcome, before: RefState, after: RefState, data,
               group_rows: int) -> float:
    """The select comparison of one selection (module docstring)."""
    m0, m1 = before.m, after.m
    added = m1 != m0
    if added:
        if m1 - m0 != group_rows or not _unchanged(before, after, m0):
            return math.inf
        rows = after.idcs[m0:m1]
        f = int(rows[0]) // group_rows
        want = torch.arange(f * group_rows, (f + 1) * group_rows, device=rows.device)
        if (not _same(rows, want) or not _same(after.pts[m0:m1], data[want].to(after.pts.dtype))
                or bool((after.wts[m0:m1] != 0).any())
                or bool((before.idcs[:m0] // group_rows == f).any())):
            return math.inf
        if before.selected is not None:
            if bool(before.selected[f]):
                return math.inf
            sel = before.selected.clone()
            sel[f] = True
            if not _same(after.selected, sel):
                return math.inf
    else:
        if not _unchanged(before, after, m0) or (
                before.selected is not None and not _same(after.selected, before.selected)):
            return math.inf
    c_best = float(out.scores.max())
    finite = out.scores[torch.isfinite(out.scores)]
    spread = max(c_best - float(finite.median()), TINY)
    if added and out.add and f == out.best:
        return 0.0
    if not added and not out.add:
        return 0.0
    if added:
        hit = out.cand == f
        if not bool(hit.any()):
            return math.inf
        s_prog = float(out.scores[hit].max())
    if added and out.add:
        return (c_best - s_prog) / spread
    if not out.hinges_on_score:
        return math.inf
    if added:      # the reference keeps its buffer: the choice scores below its best point
        return (out.core_max - s_prog) / spread
    return (c_best - out.core_max) / spread


def weight_gaps(sel: RefState, after: RefState, ref_wts: torch.Tensor) -> tuple:
    """The refinement comparison of one selection (module docstring): the
    widest and the median per-slot gap over the live slots, and the slot of
    the widest."""
    m = sel.m
    if (after.m != m or not _same(after.idcs, sel.idcs) or not _same(after.pts, sel.pts)
            or (sel.selected is not None and not _same(after.selected, sel.selected))
            or bool((after.wts[m:] != 0).any())):
        return math.inf, math.inf, -1
    if m == 0:
        return 0.0, 0.0, -1
    w_p, w_r = after.wts[:m].double(), ref_wts[:m].double()
    if not bool(torch.isfinite(w_p).all()):
        return math.inf, math.inf, -1
    med = float(w_r.abs().median())
    gaps = (w_p - w_r).abs() / torch.clamp_min(w_r.abs(), max(med, TINY))
    worst = int(torch.argmax(gaps))
    return float(gaps[worst]), float(gaps.median()), worst


class Kept:
    """The selections of the first build that the check compares (module
    docstring): ``offer`` each as the window completes it; ``items`` gives
    them in order, at most ``count``."""

    def __init__(self, count: int, rng):
        self.count, self.rng = count, rng
        self.first, self.latest = None, None
        self.drawn, self.seen = [], 0

    def offer(self, j: int, record) -> None:
        if j == 0:
            self.first = (0, record)
            return
        if self.count < 2:
            return
        if self.latest is not None:
            self._draw(self.latest)
        self.latest = (j, record)

    def _draw(self, item) -> None:
        # algorithm R over the selections between the first and the latest
        k = self.count - 2
        self.seen += 1
        if len(self.drawn) < k:
            self.drawn.append(item)
            return
        r = self.rng.randrange(self.seen)
        if r < k:
            self.drawn[r] = item

    def items(self) -> list:
        got = [x for x in (self.first, self.latest) if x is not None] + self.drawn
        return sorted(got, key=lambda x: x[0])
