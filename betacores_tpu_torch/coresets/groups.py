"""Group-mode (batch) incremental coreset builds (counterpart of
betacores_tpu/coresets/groups.py).

Selection scores whole groups: a group's tangent vector is the SUM of its
members' projections, and the winning group's members are all appended
with zero weight; the weights are then refined point by point. The group
vectors come from one (N, S) projection of every row (through the model's
fused projection on a block of at least FUSED_MIN_ROWS rows, e.g. K2 for
the multiclass model) and a group reduction: a product with the (N, G)
one-hot group matrix when it takes at most ``ONEHOT_MAX_BYTES``, else a
scatter-add of the rows into their groups. The scatter is
``index_put_(accumulate=True)``, which on a CUDA device sorts the indices
and adds each group's rows in that order: run to run it rounds the same.

Reference behaviours kept: candidates are ``n_subsample_select`` groups
drawn with replacement, deliberately not clamped to G; the first
``initialized`` warm-start slots are left out of the take-new comparison;
groups too large for the remaining capacity are masked out of the argmax
(a rejected winner would block every smaller group); a selected group that
wins again is a no-op iteration (reference parity) or is masked out of the
argmax (``dedup_select``); with ``data_weights`` u a group's vector is
sum_{n in g} u_n v_n, zero-mass groups are never selected and members with
u = 0 are dropped from the append by a stable partition.

The append writes the winner's padded (L_max,) member block into slots
m .. m + size - 1 as a gather over the slots: slot k takes member k - m
when that lies in [0, size) and the group was added, and keeps its value
otherwise. No slot outside the block is written, whatever the capacity
(the reference's scatter drops the positions past the buffer).

The refinement is SparseVI's composed route over the buffer
(coresets/incremental.py::_ComposedPass), on a subsample of the rows or,
with ``n_subsample_opt=None``, on every row against the grouped target
sum_n [gid_n < G] u_n v_n; on a CUDA device each pass is replayed as CUDA
graphs (``graph``). It never takes the fused logistic step: the
reference's group builder has none. Select stays eager and reads nothing
on the host: ``add``, ``take_new`` and ``room`` stay tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.projection import Groups, draw_subsample
from ..utils import profiling
from ..utils.opt import step_schedule
from .incremental import (ContextBuffers, GeneratorDraws, IncrementalBuilder,
                          IncrementalConfig, _generator_of, laplace_family,
                          make_tangent_error, noise_split)
from .state import CoresetState, GroupCoresetState

# The (G, S) group reduction is a (G, N) x (N, S) product with the one-hot
# group matrix while that matrix takes at most this many bytes (N * G * 4),
# and a scatter-add above it. Module-level, so tests can patch the gate and
# hold the two paths against each other.
ONEHOT_MAX_BYTES = 256 * 1024 * 1024


def group_ids_from_groups(groups: Groups, n_data: int) -> torch.Tensor:
    """(N,) int64 group id of each row on the groups' device; rows in no
    group get id G (a segment the reductions drop)."""
    members = groups.members.cpu().numpy()
    G = members.shape[0]
    gid = np.full(n_data, G, dtype=np.int64)
    for g in range(G):
        mem = members[g]
        gid[mem[mem >= 0]] = g
    return torch.from_numpy(gid).to(groups.members.device)


def init_group_state(core: CoresetState, n_groups: int, selected=None,
                     initialized: int = 0) -> GroupCoresetState:
    dev = core.wts.device
    sel = (torch.zeros(n_groups, dtype=torch.bool, device=dev) if selected is None
           else torch.as_tensor(selected, dtype=torch.bool, device=dev))
    return GroupCoresetState(core=core, selected=sel,
                             initialized=torch.full((), initialized, dtype=torch.int32,
                                                    device=dev))


class GroupIncrementalBuilder(IncrementalBuilder):
    """``build(gstate, itrs, draws)`` runs itrs x (group select + point
    refinement); ``build_trace`` also returns each iteration's (wts, idcs,
    beta, selected). Draws are those of the point builder, with select's
    subsample drawn over the G groups (``generator_draws``). Each entry
    point but ``select`` takes a contextual builder's ``ctx``, as the point
    builder's."""

    def __init__(self, data, groups: Groups, model, sampler, config: IncrementalConfig,
                 step_sizes, data_weights: Optional[torch.Tensor], graph: Optional[bool],
                 ctx: Optional[ContextBuffers] = None):
        N, dt, dev = data.shape[0], data.dtype, data.device
        G = groups.n_groups
        self.members = groups.members.to(dev)
        self.n_groups = G
        self.gid = group_ids_from_groups(groups, N).to(dev)
        in_group = (self.gid < G).to(dt)
        u = data_weights
        # the refinement's target weights: the raw u on a subsample (the
        # reference sums the subsample whatever its groups), the grouped
        # u on every row
        target_u = u if config.n_subsample_opt is not None else (
            in_group if u is None else u * in_group)
        super().__init__(data, model, sampler, config, step_sizes, target_u, graph, ctx)
        self._model_fstep = self.sclr_all = None       # the group pass is composed
        self.data_weights = u
        self._error = make_tangent_error(data, model, sampler, config, u)
        self.n_sel = config.n_subsample_select          # group candidates, not clamped to G
        if u is None:
            self.eff_sizes, self.g_mass = groups.sizes.to(dev), None
        else:
            # member counts and masses under u: u = 0 members are dropped at
            # the append, zero-mass groups are never selected
            self.eff_sizes = torch.zeros(G + 1, dtype=torch.int64, device=dev).index_add_(
                0, self.gid, (u > 0).to(torch.int64))[:G]
            self.g_mass = torch.zeros(G + 1, dtype=dt, device=dev).index_add_(
                0, self.gid, u)[:G]
        self.onehot = None
        if N * G * 4 <= ONEHOT_MAX_BYTES:
            self.onehot = (self.gid[:, None] == torch.arange(G, device=dev)[None, :]).to(dt)
        self._all_groups = torch.arange(G, device=dev)

    def generator_draws(self, generator: torch.Generator) -> GeneratorDraws:
        return GeneratorDraws(generator, self.sampler, self.data.shape[0], self.n_sel,
                              self.n_opt, self.step_sizes.shape[0],
                              self.config.projection_dim, n_candidates=self.n_groups)

    def group_reduce(self, vecs: torch.Tensor) -> torch.Tensor:
        """(G, S) sum of each group's rows of ``vecs`` (N, S); rows in no
        group are dropped."""
        if self.onehot is not None:
            return self.onehot.T @ vecs
        out = vecs.new_zeros((self.n_groups + 1, vecs.shape[1]))
        out.index_put_((self.gid,), vecs, accumulate=True)
        return out[:self.n_groups]

    def group_vecs(self, samples, beta) -> torch.Tensor:
        """(G, S) group tangent vectors: one projection of every row, then
        the group reduction (weighted: sum_{n in g} u_n v_n)."""
        vecs = self._project(self.data, samples, beta)
        if self.data_weights is not None:
            vecs = self.data_weights[:, None] * vecs
        return self.group_reduce(vecs)

    def select(self, gst: GroupCoresetState, draws, it: int = 0) -> GroupCoresetState:
        """Reference bcores.py:91-123 / sparsevi.py:97-126 (group branches)."""
        st, cfg = gst.core, self.config
        S, G, n_sel = cfg.projection_dim, self.n_groups, self.n_sel
        if self.per_step:
            gen = _generator_of(draws)
            samples, aux = self.sampler(gen, S, st.wts, st.pts, st.sampler_aux)
            cand = None if n_sel is None else draw_subsample(gen, G, n_sel)[0]
        else:
            z, cand = draws.select(it, st)
            samples, aux = self.sampler.from_noise(z, st.wts, st.pts, st.sampler_aux)
        gvecs = self.group_vecs(samples, st.beta)
        if cand is None:
            cand, scaling = self._all_groups, 1.0
        else:
            gvecs, scaling = gvecs.index_select(0, cand), G / n_sel
        corevecs = self._project(st.pts, samples, st.beta) * st.slot_mask[:, None].to(
            self.data.dtype)
        resid = scaling * gvecs.sum(dim=0) - st.wts @ corevecs
        vn = torch.sqrt(torch.sum(gvecs * gvecs, dim=1))
        vn = torch.where(vn > 0, vn, torch.inf)
        corrs = (gvecs @ resid) / vn / S
        M_max = st.wts.shape[0]
        # groups that do not fit the remaining capacity are masked out of
        # the argmax, so they never block a smaller group that fits
        corrs = torch.where(self.eff_sizes[cand] + st.m <= M_max, corrs, -torch.inf)
        if self.g_mass is not None:
            corrs = torch.where(self.g_mass[cand] > 0, corrs, -torch.inf)
        if cfg.dedup_select:
            corrs = torch.where(gst.selected[cand], -torch.inf, corrs)
        best = torch.argmax(corrs).reshape(1)
        f = cand.index_select(0, best)
        c_best = corrs.index_select(0, best)[0]
        size_f = self.eff_sizes.index_select(0, f)[0].to(st.m.dtype)
        room = st.m + size_f <= M_max
        if cfg.dedup_select:
            add = room & torch.isfinite(c_best)
        else:
            cn = torch.sqrt(torch.sum(corevecs * corevecs, dim=1))
            cn = torch.where(cn > 0, cn, torch.inf)
            slot_ids = torch.arange(M_max, device=st.m.device)
            compare = st.slot_mask & (slot_ids >= gst.initialized)
            corecorrs = torch.where(compare, torch.abs(corevecs @ resid) / cn / S, -torch.inf)
            take_new = (st.m == 0) | (c_best > corecorrs.max())
            add = take_new & ~gst.selected.index_select(0, f)[0] & room
            if self.g_mass is not None:
                # the m == 0 arm of take_new bypasses the -inf masks
                add = add & torch.isfinite(c_best)
        members = self.members.index_select(0, f)[0]               # (L_max,)
        if self.data_weights is not None:
            # u > 0 members first, in order; u = 0 members never enter
            keep = (members >= 0) & (self.data_weights[members.clamp_min(0)] > 0)
            order = torch.argsort((~keep).to(torch.uint8), stable=True)
            members = torch.where(keep, members, -1)[order]
        # the append: slot k takes member k - m of the block
        j = torch.arange(M_max, device=st.m.device) - st.m
        put = (j >= 0) & (j < size_f) & add
        mem = members.index_select(0, j.clamp(0, members.shape[0] - 1))
        core = st._replace(
            wts=torch.where(put, torch.zeros_like(st.wts), st.wts),
            idcs=torch.where(put, mem.to(st.idcs.dtype), st.idcs),
            pts=torch.where(put[:, None], self.data.index_select(0, mem.clamp_min(0)), st.pts),
            m=torch.where(add, st.m + size_f, st.m),
            sampler_aux=aux)
        selected = gst.selected | ((self._all_groups == f) & add)
        return gst._replace(core=core, selected=selected)

    @profiling.spanned("refine")
    def optimize(self, gst: GroupCoresetState, draws, it: int = 0,
                 ctx=None) -> GroupCoresetState:
        """Point-level refinement of the appended members: the composed
        pass on a subsample, or on every row against the grouped target."""
        self.load_ctx(ctx)
        return gst._replace(core=self._optimize_composed(gst.core, draws, it))

    def build(self, gst: GroupCoresetState, itrs: int, draws, ctx=None) -> GroupCoresetState:
        self.load_ctx(ctx)
        for it in range(itrs):
            gst = self.optimize(self.select(gst, draws, it), draws, it)
        return gst

    def build_trace(self, gst: GroupCoresetState, itrs: int, draws, ctx=None):
        """(gstate, (wts, idcs, beta, selected)) with each stacked over
        iterations: the selection order is the order in which the
        columns of ``selected`` turn on."""
        self.load_ctx(ctx)
        trace = []
        for it in range(itrs):
            gst = self.optimize(self.select(gst, draws, it), draws, it)
            st = gst.core
            trace.append((st.wts, st.idcs, st.beta, gst.selected))
        return gst, tuple(torch.stack(x) for x in zip(*trace))


def make_group_incremental_builder(
    data: torch.Tensor,
    groups: Groups,
    model,
    sampler,
    config: IncrementalConfig,
    step_sizes: Optional[torch.Tensor] = None,
    contextual: bool = False,
    data_weights: Optional[torch.Tensor] = None,
    graph: Optional[bool] = None,
) -> GroupIncrementalBuilder:
    """The group builder over ``data`` (N, D) on its device; ``groups`` is
    moved there. ``data_weights`` (N,) makes row n count u_n times.
    ``graph`` and ``contextual`` as in make_incremental_builder."""
    if config.learn_beta:
        raise NotImplementedError(
            "group-mode builders do not implement learn_beta (the joint (w, beta) "
            "refinement exists on the point builders only; the reference's group mode "
            "never learns beta either): keeping beta fixed while the caller asked to "
            "learn it would be a wrong result. Use learn_beta=False (and "
            "coresets/select_beta.py to choose beta).")
    ctx = None
    if contextual:
        ctx = ContextBuffers(data.device)
        model, sampler = model(ctx), sampler(ctx)
    if not noise_split(sampler) and not callable(sampler):
        raise ValueError("the sampler has neither a noise split (draw_noise, from_noise) "
                         "nor a call sampler(generator, n, wts, pts, aux)")
    if config.refit_every > 1 and not laplace_family(sampler):
        raise ValueError("refit_every > 1 needs a sampler with fit, from_fit and fit_aux")
    N = data.shape[0]
    if data_weights is not None:
        if tuple(data_weights.shape) != (N,):
            raise ValueError(f"data_weights must be ({N},), got {tuple(data_weights.shape)}")
        data_weights = data_weights.to(dtype=data.dtype, device=data.device)
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return GroupIncrementalBuilder(data, groups, model, sampler, config, step_sizes,
                                   data_weights, graph, ctx)
