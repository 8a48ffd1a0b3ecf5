"""The sharded group (batch) build on ``torch.distributed`` (counterpart of
betacores_tpu/parallel/groups.py).

The dataset's N rows are split over the mesh's ``data`` axis with their
group ids (``shard_data``, ``shard_group_ids``; padding rows get id G and
join no group) and the S samples of every projection over its ``samp``
axis; the G groups are few and REPLICATED. Per iteration:

  * select: every rank projects its local rows and reduces them into the
    (G, S_loc) group sums, a one-hot product below
    ``coresets.groups.ONEHOT_MAX_BYTES`` and a sorted scatter above it, as
    the single-device builder does (coresets/groups.py), then one psum
    over ``data`` gives the replicated group vectors. The candidates (all
    G groups, or ``n_subsample_select`` drawn with replacement from the
    replicated stream), the scores, the capacity, zero-mass and dedup masks
    and the argmax run REPLICATED; every inner product over S takes one
    psum over ``samp``. The winner's members are gathered from the shards
    that own them by one psum over ``data`` of an (L_max, D) block (a
    weighted build carries u as one more column), and appended as the
    single-device builder appends them (u = 0 members dropped by a stable
    partition);
  * optimize: the replicated projected Adam over the point weights, each
    step refitting the posterior: over every local row against the
    grouped target sum_n [gid_n < G] u_n v_n (the masked weighted column
    sum of the reference's exact-gradient refinement), psum'd over
    ``data``; or on a stratified per-shard subsample of
    ``n_subsample_opt // n_data`` rows, rescaled by local_valid / n_loc as
    the sharded point builder's.

The projections of a block on a mesh whose ``samp`` axis has size 1 are
centred over the whole S locally, through the model's fused projection
(coresets/incremental.py's ``project_beta``/``project_ll``): a block of at
least FUSED_MIN_ROWS rows of the multiclass model goes to K2
(ops/kernels.py::multiclass_projection), as in the single-device group
build. With ``samp`` > 1 the blocks are projected uncentred and centred
with one psum over ``samp`` of their row sums, as the sharded point
builder's. Both compute the reference's ``_proj``.

Select and the refinement run eagerly (the refinement is nn_adam over the
pass's steps, dispatched from Python, as the sharded point builder's
composed route); nothing reads a device value on the host. Draws are
separate from compute: ``generator_draws(seed)`` draws the noise and the
candidates from a replicated generator and the subsample indices from a
generator seeded per data shard; ``coresets.FixedDraws`` replays given
draws (candidates replicated, subsample indices each rank's local ones).
A sampler without a noise split (the NIW sampler) is called on the
replicated generator at select and at every step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..coresets import groups as single_groups
from ..coresets.groups import GroupCoresetState
from ..coresets.incremental import IncrementalConfig, noise_split
from ..ops.projection import Groups, draw_subsample, project_beta, project_ll
from ..utils.opt import step_schedule
from .mesh import DATA_AXIS, SAMP_AXIS, Mesh, require_axes
from .sharded import ShardedGeneratorDraws, ShardedIncrementalBuilder


@dataclasses.dataclass
class ShardedGroupDraws(ShardedGeneratorDraws):
    """``ShardedGeneratorDraws`` whose select draws its ``n_sel``
    candidates over the G groups from the replicated generator."""

    n_groups: int = 0

    def select(self, it, st):
        z = self._noise(self.n_samples, st)
        if self.n_sel is None:
            return z, None
        return z, draw_subsample(self.replicated, self.n_groups, self.n_sel)[0]


class ShardedGroupBuilder(ShardedIncrementalBuilder):
    """``build(gstate, itrs, draws)`` runs itrs x (group select + point
    refinement) on this rank's shard; ``build_trace`` also returns each
    iteration's (wts, idcs, selected), the reference's ``build.trace``.
    The group state is replicated: every rank passes and gets the same."""

    def __init__(self, data_local, gid_local, n_true: int, groups: Groups, model, sampler,
                 config: IncrementalConfig, mesh: Mesh, step_sizes, u_local):
        super().__init__(data_local, n_true, model, sampler, config, mesh, step_sizes,
                         u_local, graph=False)
        dt, dev = data_local.dtype, data_local.device
        G = groups.n_groups
        self.route = "group"
        self.n_groups, self.n_sel = G, config.n_subsample_select   # candidates, not clamped
        self.members = groups.members.to(dev)
        self.gid = gid_local.to(dev)
        in_group = (self.gid < G).to(dt)
        # the exact refinement's target weights: [gid_n < G] u_n
        self.target_u = in_group if u_local is None else u_local * in_group
        if u_local is None:
            self.eff_sizes, self.g_mass = groups.sizes.to(dev), None
        else:
            # member counts and masses under u, constant per build: one psum
            # over data each
            self.eff_sizes = mesh.psum(torch.zeros(G + 1, dtype=torch.int64, device=dev)
                                       .index_add_(0, self.gid, (u_local > 0).to(torch.int64)),
                                       DATA_AXIS)[:G]
            self.g_mass = mesh.psum(torch.zeros(G + 1, dtype=dt, device=dev)
                                    .index_add_(0, self.gid, u_local), DATA_AXIS)[:G]
        rows = data_local.shape[0]
        self.onehot = None
        # the single-device builder's gate, read at make time (tests patch it)
        if rows * G * 4 <= single_groups.ONEHOT_MAX_BYTES:
            self.onehot = (self.gid[:, None] == torch.arange(G, device=dev)[None, :]).to(dt)
        self._all_groups = torch.arange(G, device=dev)

    def generator_draws(self, seed: int) -> ShardedGroupDraws:
        """The replicated generator seeded with ``seed`` on every rank, the
        local one with ``seed`` and this rank's data shard."""
        return ShardedGroupDraws(**vars(super().generator_draws(seed)),
                                 n_groups=self.n_groups)

    def _project(self, blocks, samples_loc, beta):
        """The centred projections of each row block: on a ``samp`` axis of
        size 1 locally, through the model's fused projection; else
        uncentred and centred with one psum over ``samp``."""
        if self.mesh.n_samp > 1:
            return super()._project(blocks, samples_loc, beta)
        if self.config.use_beta:
            return [project_beta(self.model, p, samples_loc, beta) for p in blocks]
        return [project_ll(self.model, p, samples_loc) for p in blocks]

    def _rows(self, idx):
        """Every local row (``idx`` None) is weighed by the grouped target
        weights [gid_n < G] u_n, which also mask the padding rows; a
        subsample as the point builder's."""
        if idx is None:
            return self.data, self.target_u, 1.0, None
        return super()._rows(idx)

    def group_reduce(self, vecs: torch.Tensor) -> torch.Tensor:
        """(G, S_loc) sum of each group's local rows of ``vecs``; padding
        rows (id G) are dropped."""
        if self.onehot is not None:
            return self.onehot.T @ vecs
        out = vecs.new_zeros((self.n_groups + 1, vecs.shape[1]))
        out.index_put_((self.gid,), vecs, accumulate=True)
        return out[:self.n_groups]

    def _gather_members(self, members):
        """(L_max, D) rows of a padded (L_max,) block of global indices, and
        their base weights (None unweighted): each row lives on one shard,
        so one psum over ``data`` assembles the replicated block."""
        rows_loc = self.rows_loc
        rel = members - self.mesh.ax_d * rows_loc
        owner = (members >= 0) & (rel >= 0) & (rel < rows_loc)
        at = rel.clamp(0, rows_loc - 1)
        local = self.data.index_select(0, at)
        if self.u is not None:
            local = torch.cat([local, self.u.index_select(0, at)[:, None]], dim=1)
        block = self.mesh.psum(torch.where(owner[:, None], local, 0.0), DATA_AXIS)
        if self.u is None:
            return block, None
        return block[:, :-1], block[:, -1]

    def select(self, gst: GroupCoresetState, draws, it: int = 0) -> GroupCoresetState:
        """Reference parallel/groups.py:190-277: local projection and group
        reduction, one psum over ``data``, a replicated group argmax, the
        owner-shard gather of the winner's members."""
        st, cfg, mesh = gst.core, self.config, self.mesh
        S, G, n_sel, dt = self.S, self.n_groups, self.n_sel, self.data.dtype
        if self.per_step_draws:
            samples, aux = self.sampler(draws.replicated, S, st.wts, st.pts, st.sampler_aux)
            cand = None if n_sel is None else draw_subsample(draws.replicated, G, n_sel)[0]
        else:
            z, cand = draws.select(it, st)
            samples, aux = self.sampler.from_noise(z, st.wts, st.pts, st.sampler_aux)
        vecs, corevecs = self._project([self.data, st.pts], self._samples_loc(samples), st.beta)
        if self.u is not None:
            vecs = self.u[:, None] * vecs
        gvecs = mesh.psum(self.group_reduce(vecs), DATA_AXIS)          # (G, S_loc)
        if cand is None:
            cand, scaling = self._all_groups, 1.0
        else:
            gvecs, scaling = gvecs.index_select(0, cand), G / n_sel
        corevecs = corevecs * st.slot_mask[:, None].to(dt)
        resid = scaling * gvecs.sum(dim=0) - st.wts @ corevecs
        n_c, M_max = gvecs.shape[0], st.wts.shape[0]
        # every inner product over S in one psum over samp
        red = mesh.psum(torch.cat([gvecs @ resid, torch.sum(gvecs * gvecs, dim=1),
                                   corevecs @ resid, torch.sum(corevecs * corevecs, dim=1)]),
                        SAMP_AXIS)
        corr_num, vn2, core_num, cn2 = torch.split(red, [n_c, n_c, M_max, M_max])
        vn = torch.sqrt(vn2)
        vn = torch.where(vn > 0, vn, torch.inf)
        corrs = corr_num / vn / S
        # groups that do not fit the remaining capacity never block one that does
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
            cn = torch.sqrt(cn2)
            cn = torch.where(cn > 0, cn, torch.inf)
            slot_ids = torch.arange(M_max, device=st.m.device)
            compare = st.slot_mask & (slot_ids >= gst.initialized)
            corecorrs = torch.where(compare, torch.abs(core_num) / cn / S, -torch.inf)
            take_new = (st.m == 0) | (c_best > corecorrs.max())
            add = take_new & ~gst.selected.index_select(0, f)[0] & room
            if self.g_mass is not None:
                # the m == 0 arm of take_new bypasses the -inf masks
                add = add & torch.isfinite(c_best)
        members = self.members.index_select(0, f)[0]               # (L_max,), -1 padded
        pts_f, u_f = self._gather_members(members)
        if u_f is not None:
            # u > 0 members (and their rows) first, in order; u = 0 never enter
            keep = (members >= 0) & (u_f > 0)
            order = torch.argsort((~keep).to(torch.uint8), stable=True)
            members = torch.where(keep, members, -1)[order]
            pts_f = torch.where(keep[:, None], pts_f, 0.0)[order]
        # the append: slot k takes member k - m of the block
        j = torch.arange(M_max, device=st.m.device) - st.m
        put = (j >= 0) & (j < size_f) & add
        at = j.clamp(0, members.shape[0] - 1)
        core = st._replace(
            wts=torch.where(put, torch.zeros_like(st.wts), st.wts),
            idcs=torch.where(put, members.index_select(0, at).to(st.idcs.dtype), st.idcs),
            pts=torch.where(put[:, None], pts_f.index_select(0, at), st.pts),
            m=torch.where(add, st.m + size_f, st.m),
            sampler_aux=aux)
        selected = gst.selected | ((self._all_groups == f) & add)
        return gst._replace(core=core, selected=selected)

    def optimize(self, gst: GroupCoresetState, draws, it: int = 0) -> GroupCoresetState:
        """Reference parallel/groups.py:279-313: the replicated projected
        Adam over the point weights, exact over every local row or on the
        stratified subsample."""
        return gst._replace(core=self._optimize_per_step(gst.core, draws, it))

    def build_trace(self, gst: GroupCoresetState, itrs: int, draws):
        """(gstate, (wts, idcs, selected)) with each stacked over
        iterations: the selection order is the order in which the columns
        of ``selected`` turn on."""
        trace = []
        for it in range(itrs):
            gst = self.optimize(self.select(gst, draws, it), draws, it)
            trace.append((gst.core.wts, gst.core.idcs, gst.selected))
        return gst, tuple(torch.stack(x) for x in zip(*trace))


def make_sharded_group_builder(
    data_local: torch.Tensor,
    gid_local: torch.Tensor,
    n_true: int,
    groups: Groups,
    model,
    sampler,
    config: IncrementalConfig,
    mesh: Mesh,
    step_sizes: Optional[torch.Tensor] = None,
    data_weights: Optional[torch.Tensor] = None,
) -> ShardedGroupBuilder:
    """The group builder of this rank over its row block ``data_local`` of
    an (n_true, D) dataset and its block ``gid_local`` of the group ids
    (``shard_data``, ``shard_group_ids``). ``data_weights`` is this rank's
    block of (N,) base weights (``shard_weights``): a group's vector is
    sum_{n in g} u_n v_n, zero-mass groups are never selected and u = 0
    members never enter the coreset. Select and the refinement run
    eagerly."""
    if config.learn_beta:
        raise NotImplementedError(
            "group-mode builders do not implement learn_beta (the joint (w, beta) "
            "refinement exists on the point builders only; the reference's group mode "
            "never learns beta either): keeping beta fixed while the caller asked to "
            "learn it would be a wrong result. Use learn_beta=False (and "
            "coresets/select_beta.py to choose beta).")
    n_data, n_samp = require_axes(mesh)
    if config.refit_every > 1:
        raise NotImplementedError("the sharded group build refits the posterior at every "
                                  "step, as the reference's: use refit_every=1")
    if not noise_split(sampler) and not callable(sampler):
        raise ValueError("the sampler has neither a noise split (draw_noise, from_noise) "
                         "nor a call sampler(generator, n, wts, pts, aux)")
    rows = data_local.shape[0]
    if tuple(gid_local.shape) != (rows,):
        raise ValueError(f"gid_local must be ({rows},) (padded like the rows: use "
                         f"shard_group_ids), got {tuple(gid_local.shape)}")
    if config.projection_dim % n_samp:
        raise ValueError(f"projection_dim {config.projection_dim} must divide over samp "
                         f"axis {n_samp}")
    if data_weights is not None:
        if tuple(data_weights.shape) != (rows,):
            raise ValueError(f"data_weights must be ({rows},) (padded like the rows: use "
                             f"shard_weights), got {tuple(data_weights.shape)}")
        data_weights = data_weights.to(dtype=data_local.dtype, device=data_local.device)
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data_local.dtype,
                                   device=data_local.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data_local.dtype, device=data_local.device)
    return ShardedGroupBuilder(data_local, gid_local, n_true, groups, model, sampler, config,
                               mesh, step_sizes, data_weights)
