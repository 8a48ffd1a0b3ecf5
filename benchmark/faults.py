"""Broken programs for the check's own tests and readings: the port with
its timed path broken underneath, one fault each that a one-card cell can
have. Each is an ``impl_factory`` of harness.run (cell, inputs, device).

- ``unchanged``: the refinement pass returns its state unchanged.
- ``half_batch``: half of each step's rows left out, the mean taken over
  the rest (the second half of the rows repeats the first; on the exact
  gradient, the first half of the rows counts twice and the rest not).
- ``altered``: the installed row (group) moved to the next one where
  select produces it.
- ``duplicate``: select installs again the row (group) already in the
  buffer's first slots in place of its pick.

The exchange between cards does not exist on one card."""

from __future__ import annotations

import torch

from . import harness


def unchanged(cell, inputs, device):
    port = harness.PortImpl(cell, inputs, device)
    port.optimize = lambda st, it: st
    return port


def half_batch(cell, inputs, device):
    if inputs.opt_idx is not None:
        idx = inputs.opt_idx.clone()
        h = idx.shape[-1] // 2
        idx[..., h:2 * h] = idx[..., :h]
        return harness.PortImpl(cell, inputs._replace(opt_idx=idx), device)
    port = harness.PortImpl(cell, inputs, device)
    N = inputs.data.shape[0]
    u = torch.zeros(N, dtype=inputs.data.dtype, device=inputs.data.device)
    u[:N // 2] = 2.0
    port.builder.u = u
    return port


def _reinstall(cell, inputs, device, rows_of):
    """The port whose select installs ``rows_of(core, m0, m1)`` in place of
    the rows it picked (None: its own pick)."""
    port = harness.PortImpl(cell, inputs, device)
    select, per, G = port.select, cell.route["group_rows"], cell.route["n_groups"]

    def select_broken(st, it):
        m0 = int(getattr(st, "core", st).m)
        out = select(st, it)
        core = getattr(out, "core", out)
        m1 = int(core.m)
        rows = None if m1 == m0 else rows_of(core, m0, m1)
        if rows is None:
            return out
        f_was = int(core.idcs[m0]) // per
        idcs, pts = core.idcs.clone(), core.pts.clone()
        idcs[m0:m1], pts[m0:m1] = rows.to(idcs.dtype), inputs.data[rows]
        core = core._replace(idcs=idcs, pts=pts)
        if G is None:
            return core
        selected = out.selected.clone()
        selected[f_was] = bool(getattr(st, "selected")[f_was])
        selected[int(rows[0]) // per] = True
        return out._replace(core=core, selected=selected)

    port.select = select_broken
    return port


def altered(cell, inputs, device):
    N, per = inputs.data.shape[0], cell.route["group_rows"]
    return _reinstall(cell, inputs, device,
                      lambda core, m0, m1: (core.idcs[m0:m1].long() + per) % N)


def duplicate(cell, inputs, device):
    return _reinstall(cell, inputs, device,
                      lambda core, m0, m1: core.idcs[:m1 - m0].long() if m0 > 0 else None)


FAULTS = {f.__name__: f for f in (unchanged, half_batch, altered, duplicate)}
