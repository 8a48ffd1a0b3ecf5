"""The sharded incremental beta-Cores build on ``torch.distributed``
(counterpart of betacores_tpu/parallel/sharded.py).

One process per mesh rank. The dataset's N rows are split over the mesh's
``data`` axis (``mesh.shard_data``) and the S posterior samples of every
projection over its ``samp`` axis. Per iteration:

  * posterior sampling and the weight refinement are REPLICATED: every rank
    draws the same noise from a generator seeded alike and computes the
    same values, so no parameter is broadcast;
  * candidate scoring is LOCAL: each data shard draws its own subsample
    (or takes every local row) and scores it against the residual;
  * the Sigma-over-N term of the residual is one psum over ``data``, and
    every inner product over S is a psum over ``samp``;
  * the greedy selection is a DISTRIBUTED ARGMAX: a local top-1, then an
    all_gather over ``data`` of (score, global index, point) and a
    replicated argmax. Ties go to the lower shard (torch.argmax takes the
    first maximum).

The refinement takes one of three routes, as in the reference:
  * fused: a model with shard partials (logistic regression, K3:
    ops/kernels.py::logreg_shard_step_partials) on an unweighted build with
    a Laplace-family sampler runs each Adam step as one Newton refit, one
    K3 launch, a psum over ``data`` of the column sums, one packed psum over
    ``samp`` and an O(M) Adam epilogue;
  * composed: any other model, or a weighted build, through
    utils/opt.py::nn_adam on pre-drawn noise and rows;
  * per step: full-data refinement (``n_subsample_opt=None``) projects
    every local row at each step; and a sampler without a noise split
    (the NIW sampler of models/mvn.py, reference sharded.py:442-452)
    draws inside each step: ``sampler(generator, S, w, pts, aux)`` on the
    replicated generator, then the step's shard-local subsample.

``learn_beta`` (route "learn_beta", reference sharded.py:453-477) is the
single-device builder's joint (w, beta) update, replicated: every step
refits, projects the local rows and the buffer with the buffer's
beta-gradient (their centring in one psum over ``samp``), psums the target
over ``data``, and takes both inner products over S in one more psum over
``samp``. It runs eagerly, subsampled or over every local row.

Draws are separate from compute, as in the single-device builder:
``build`` takes a draws provider. ``ShardedGeneratorDraws`` draws the
replicated noise from one generator and the shard-local subsample indices
(in [0, max(local_valid, 1))) from another, seeded per data shard;
``coresets.FixedDraws`` replays given draws, with each rank's LOCAL
indices. A sampler without a noise split is called on the draws'
``replicated`` generator at select and at every step, and the subsample
indices come from ``local_indices(n)``: a world of one given the same
generator for both draws what the single-device per-step-draw route draws
(coresets/incremental.py). No loop body reads a device value on the host.

The fused route's pass is a device-resident program, as in the
single-device builder (coresets/incremental.py): static buffers
(ops/kernels.py::FusedPass), and on a CUDA device the step body, its two
all-reduces included, captured as a CUDA graph and replayed
(utils/graphs.py; ``graph=None`` captures on a CUDA device, ``False`` runs
the same body eagerly, ``True`` off a CUDA device raises). A replay adds
the collectives its graph holds to ``mesh.calls``. The composed and
per-step routes and select stay eager.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..coresets.incremental import (BETA_FLOOR, Draws, IncrementalConfig, laplace_family,
                                   noise_split, require_lagged_fit)
from ..coresets.state import CoresetState
from ..ops.kernels import ADAM_B1, ADAM_B2, ADAM_EPS, FusedPass, adam_sclr_stack
from ..utils.graphs import PassRunner, capture_stats, resolve_graph
from ..utils.opt import adam_bias_corrections, adam_update, nn_adam, step_schedule
from .mesh import DATA_AXIS, SAMP_AXIS, Mesh, require_axes


@dataclasses.dataclass
class ShardedGeneratorDraws:
    """Draws of one rank: the replicated noise from ``replicated`` (seeded
    alike on every rank, and never advanced by a local draw), the
    shard-local subsample indices from ``local`` (seeded per data shard)."""

    replicated: torch.Generator
    local: torch.Generator
    sampler: object
    local_valid: int
    n_sel: Optional[int]              # per shard; None: every local row
    n_opt: Optional[int]
    n_steps: int
    n_samples: int

    def _noise(self, n, st):
        return self.sampler.draw_noise(self.replicated, n, st.wts, st.pts,
                                       st.sampler_aux)

    def local_indices(self, n):
        """n shard-local subsample indices in [0, max(local_valid, 1))."""
        return torch.randint(0, max(self.local_valid, 1), (n,), generator=self.local,
                             device=self.local.device)

    def select(self, it, st):
        z = self._noise(self.n_samples, st)
        return z, None if self.n_sel is None else self.local_indices(self.n_sel)

    def optimize(self, it, st):
        T, S = self.n_steps, self.n_samples
        z = self._noise(T * S, st).reshape(T, S, -1)
        if self.n_opt is None:
            return z, None
        return z, self.local_indices(T * self.n_opt).reshape(T, self.n_opt)


class ShardedIncrementalBuilder:
    """``build(state, itrs, draws)`` runs itrs x (select + optimize) on this
    rank's shard; ``build_trace`` also returns each iteration's
    (wts, idcs, beta); ``select`` / ``optimize`` run one half-iteration.
    The state is replicated: every rank passes and gets the same one."""

    def __init__(self, data_local, n_true: int, model, sampler,
                 config: IncrementalConfig, mesh: Mesh, step_sizes: torch.Tensor,
                 u_local: Optional[torch.Tensor], graph: Optional[bool] = None):
        n_data, n_samp = require_axes(mesh)
        self.graph = resolve_graph(graph, data_local.device)
        self._fused: Optional[FusedPass] = None
        self._bias_corrections: dict = {}
        S = config.projection_dim
        self.data, self.u = data_local, u_local
        self.model, self.sampler, self.config, self.mesh = model, sampler, config, mesh
        self.step_sizes = step_sizes
        self.S, self.S_loc = S, S // n_samp
        self.samp_lo = mesh.ax_s * self.S_loc
        rows = data_local.shape[0]
        self.rows_loc = rows
        self.local_valid = min(max(n_true - mesh.ax_d * rows, 0), rows)
        self.n_sel = (None if config.n_subsample_select is None
                      else max(1, config.n_subsample_select // n_data))
        self.n_opt = (None if config.n_subsample_opt is None
                      else max(1, config.n_subsample_opt // n_data))
        dt, dev = data_local.dtype, data_local.device
        self.has_rows = torch.full((), float(self.local_valid > 0), dtype=dt, device=dev)
        # the reference's local_valid.astype(dtype) / n_loc, on the device
        valid = torch.full((), self.local_valid, dtype=dt, device=dev)
        self.sel_scale = None if self.n_sel is None else valid / self.n_sel
        self.opt_scale = None if self.n_opt is None else valid / self.n_opt
        # the fused step's own float32 copy, made once: a captured step reads
        # it at this address at every replay
        self.opt_scale_f32 = (None if self.opt_scale is None
                              else self.opt_scale.to(torch.float32))
        self.row_valid = (torch.arange(rows, device=dev) < self.local_valid).to(dt)
        self.lagged = config.refit_every > 1
        self.per_step_draws = not noise_split(sampler)
        self.fstep = getattr(model, "fused_beta_shard_partials" if config.use_beta
                             else "fused_ll_shard_partials", None)
        if config.learn_beta:
            self.route = "learn_beta"
        elif self.n_opt is None or self.per_step_draws:
            self.route = "per_step"
        elif self.fstep is not None and u_local is None and laplace_family(sampler):
            self.route = "fused"
        else:
            self.route = "composed"
        self.sclr_all = adam_sclr_stack(step_sizes) if self.route == "fused" else None

    def capture_stats(self) -> tuple:
        """(CUDA graphs captured so far, host seconds spent capturing)."""
        return capture_stats((self._fused,))

    def generator_draws(self, seed: int) -> ShardedGeneratorDraws:
        """The default draws provider of this rank: the replicated generator
        seeded with ``seed`` on every rank, the local one with ``seed`` and
        this rank's data shard."""
        dev = self.data.device
        rep = torch.Generator(device=dev).manual_seed(seed)
        loc = torch.Generator(device=dev).manual_seed(seed ^ ((self.mesh.ax_d + 1) << 32))
        return ShardedGeneratorDraws(rep, loc, self.sampler, self.local_valid, self.n_sel,
                                     self.n_opt, self.step_sizes.shape[0], self.S)

    # ---- projections over the sharded sample axis ----

    def _lik(self, pts, samples_loc, beta):
        if self.config.use_beta:
            return self.model.beta_likelihood(pts, samples_loc, beta)
        return self.model.log_likelihood(pts, samples_loc)

    def _project(self, blocks, samples_loc, beta):
        """The (n, S_loc) projections of each row block, centred over the
        WHOLE sample axis: one psum over ``samp`` of all blocks' row sums."""
        lls = [self._lik(p, samples_loc, beta) for p in blocks]
        sums = self.mesh.psum(torch.cat([ll.sum(dim=1) for ll in lls]), SAMP_AXIS)
        means = torch.split(sums / self.S, [ll.shape[0] for ll in lls])
        return [ll - mu[:, None] for ll, mu in zip(lls, means)]

    def _samples_loc(self, samples):
        return samples[self.samp_lo:self.samp_lo + self.S_loc]

    def _target(self, vecs, usub, scale):
        """psum over ``data`` of the local Sigma-over-N estimate:
        scale * sum_n u_n v_n (scale None: every local row, exact)."""
        rowsum = vecs.sum(dim=0) if usub is None else usub @ vecs
        return self.mesh.psum(rowsum if scale is None else scale * rowsum, DATA_AXIS)

    # ---- select ----

    def select(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference sharded.py:166-240: local scoring, distributed argmax."""
        cfg, mesh, data, S = self.config, self.mesh, self.data, self.S
        if self.per_step_draws:
            samples, aux = self.sampler(draws.replicated, S, st.wts, st.pts, st.sampler_aux)
            sub = None if self.n_sel is None else draws.local_indices(self.n_sel)
        else:
            z, sub = draws.select(it, st)
            samples, aux = self.sampler.from_noise(z, st.wts, st.pts, st.sampler_aux)
        samples_loc = self._samples_loc(samples)
        mask = st.slot_mask[:, None].to(data.dtype)
        rows = data if sub is None else data[sub]
        vecs, corevecs = self._project([rows, st.pts], samples_loc, st.beta)
        corevecs = corevecs * mask
        if sub is None:
            vecs = vecs * self.row_valid[:, None]
            usub = self.u
        else:
            vecs = vecs * self.has_rows
            usub = None if self.u is None else self.u[sub]
        total = self._target(vecs, usub, None if sub is None else self.sel_scale)
        resid = total - st.wts @ corevecs                        # (S_loc,)
        n = vecs.shape[0]
        # every inner product over S in one psum over samp
        red = mesh.psum(torch.cat([vecs @ resid, torch.sum(vecs * vecs, dim=1),
                                   corevecs @ resid,
                                   torch.sum(corevecs * corevecs, dim=1)]), SAMP_AXIS)
        corr_num, vn2, core_num, cn2 = torch.split(red, [n, n] + [st.pts.shape[0]] * 2)
        vn = torch.sqrt(vn2)
        vn = torch.where(vn > 0, vn, torch.inf)
        corrs = corr_num / vn / S
        if sub is None:
            corrs = torch.where(self.row_valid > 0, corrs, -torch.inf)
        elif self.local_valid == 0:
            corrs = torch.full_like(corrs, -torch.inf)   # a padding-only shard
        if usub is not None:
            corrs = torch.where(usub > 0, corrs, -torch.inf)
        M_max = st.wts.shape[0]
        if cfg.dedup_select:
            corrs = torch.where(self._selected_here(st, sub), -torch.inf, corrs)

        # distributed argmax: local top-1, then one all_gather over data of
        # (score, global index, point), exact in float64
        best = torch.argmax(corrs).reshape(1)
        sel_row = best if sub is None else sub.index_select(0, best)
        cand = torch.cat([corrs.index_select(0, best).double(),
                          (mesh.ax_d * self.rows_loc + sel_row).double(),
                          data.index_select(0, sel_row)[0].double()])
        cands = mesh.all_gather(cand, DATA_AXIS)               # (n_data, 2 + D)
        win = cands.index_select(0, torch.argmax(cands[:, 0]).reshape(1))[0]
        f_score, f = win[0], win[1:2].to(torch.int32)
        f_pt = win[2:].to(data.dtype)

        if cfg.dedup_select:
            add = (st.m < M_max) & torch.isfinite(f_score)
        else:
            cn = torch.sqrt(cn2)
            cn = torch.where(cn > 0, cn, torch.inf)
            corecorrs = torch.where(st.slot_mask, torch.abs(core_num) / cn / S, -torch.inf)
            take_new = (st.m == 0) | (f_score > corecorrs.max())
            already = torch.any((st.idcs == f) & st.slot_mask)
            add = take_new & ~already & (st.m < M_max)
            if self.u is not None:
                # the m == 0 arm bypasses the -inf masks: never install a
                # masked (zero-weight) candidate
                add = add & torch.isfinite(f_score)
        slot = torch.clamp(st.m, max=M_max - 1)
        put = (torch.arange(M_max, device=st.m.device) == slot) & add
        return st._replace(
            idcs=torch.where(put, f, st.idcs),
            pts=torch.where(put[:, None], f_pt[None, :], st.pts),
            m=st.m + add.to(torch.int32),
            sampler_aux=aux)

    def _selected_here(self, st, sub):
        """(n_candidates,) bool: the candidate's row is already in the
        coreset. The live slots' global indices that fall in this shard are
        scattered into a (rows_loc,) hit count; no collective is needed,
        since the state is replicated."""
        local = st.idcs.to(torch.int64) - self.mesh.ax_d * self.rows_loc
        here = st.slot_mask & (local >= 0) & (local < self.rows_loc)
        hits = torch.zeros(self.rows_loc, dtype=torch.int32, device=self.data.device)
        hits.scatter_add_(0, torch.where(here, local, 0), here.to(torch.int32))
        return (hits if sub is None else hits[sub]) > 0

    # ---- optimize ----

    def optimize(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference sharded.py:242-451 on pre-drawn draws."""
        if self.route == "fused":
            return self._optimize_fused(st, draws, it)
        if self.route == "composed":
            return self._optimize_composed(st, draws, it)
        if self.route == "learn_beta":
            return self._optimize_learn_beta(st, draws, it)
        return self._optimize_per_step(st, draws, it)

    def _optimize_fused(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """One Newton refit, one K3 launch, two psums and the Adam epilogue
        per step, on the pass's static buffers. K3 skips the centring (the
        mean is over the sharded S axis); the gradient uses the exact
        uncentred identity g = -(a - (r / S) * b) / S."""
        mesh, data, S, S_loc = self.mesh, self.data, self.S, self.S_loc
        f32 = torch.float32
        z_all, idx_all = draws.optimize(it, st)
        z_loc = z_all[:, self.samp_lo:self.samp_lo + S_loc]
        p = self._fused
        if p is None or not p.serves(st, z_loc):
            runner = PassRunner(self.graph, calls=mesh.calls)
            p = self._fused = FusedPass(self.sampler, st, z_loc, self.n_opt, S_loc,
                                        self.sclr_all, torch.empty(0, dtype=f32),
                                        self.config.refit_every, data.dtype, runner)
        p.fill(data[idx_all], st, z_loc, self.has_rows.to(f32))
        scale, M_pad = self.opt_scale_f32, p.M_pad

        def step(refit: bool) -> None:
            if refit:
                p.refit()
            xin, z, sclr = p.step_operands()
            colsum, core, corerow, wcore = self.fstep(xin, z, p.mu, p.linv, p.w, p.sc, S_loc)
            total = mesh.psum(scale * colsum, DATA_AXIS)          # (1, s_pad)
            r_unc = total - wcore
            packed = mesh.psum(torch.cat([r_unc @ core.T, corerow,
                                          r_unc.sum(dim=1, keepdim=True)], dim=1),
                               SAMP_AXIS)
            a, r, b = packed[:, :M_pad], packed[:, M_pad:2 * M_pad], packed[:, 2 * M_pad:]
            g = -(a - (r / S) * b) / S
            p.advance(*adam_update(p.w, p.m1, p.m2, g, sclr[0], sclr[1], sclr[2],
                                   b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS))

        p.run(step)
        return p.result(st)

    def _bc(self, w):
        """nn_adam's bias corrections for weights like ``w``: formed on the
        host, so once per builder and not per pass."""
        key = (w.dtype, w.device)
        if key not in self._bias_corrections:
            self._bias_corrections[key] = adam_bias_corrections(self.step_sizes.shape[0], *key)
        return self._bias_corrections[key]

    def _samples_at(self, st):
        """(samples_at(w, carry, z, i) -> (samples, carry), carry0): the
        sampler per step, refitting every step or, lagged, every k-th."""
        smp = self.sampler
        if not self.lagged:
            return (lambda w, aux, z, i: smp.from_noise(z, w, st.pts, aux),
                    st.sampler_aux)
        k = self.config.refit_every

        def samples_at(w, lap, z, i):
            if i % k == 0 and i > 0:
                lap = smp.fit(w, st.pts, smp.fit_aux(lap))
            return smp.from_fit(lap, z), lap

        return samples_at, smp.fit(st.wts, st.pts, st.sampler_aux)

    def _optimize_composed(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """nn_adam on pre-drawn noise and local rows; each step projects
        [local subsample; coreset buffer] as one block (centring is per
        row)."""
        n_opt, S, mesh = self.n_opt, self.S, self.mesh
        z_all, idx_all = draws.optimize(it, st)
        T, M_buf = z_all.shape[0], st.pts.shape[0]
        rows_all = torch.cat([self.data[idx_all], st.pts.expand(T, *st.pts.shape)], dim=1)
        xs = (z_all, rows_all) if self.u is None else (z_all, rows_all, self.u[idx_all])
        mask = st.slot_mask[:, None].to(self.data.dtype)
        samples_at, carry0 = self._samples_at(st)

        def grad_fn(w, carry, i, xs_i):
            z, rows = xs_i[0], xs_i[1]
            samples, carry = samples_at(w, carry, z, i)
            allvecs, = self._project([rows], self._samples_loc(samples), st.beta)
            vecs = allvecs[:n_opt] * self.has_rows
            corevecs = allvecs[n_opt:] * mask
            total = self._target(vecs, xs_i[2] if len(xs_i) > 2 else None, self.opt_scale)
            resid = total - w @ corevecs
            return -mesh.psum(corevecs @ resid, SAMP_AXIS) / S, carry

        w_new, carry = nn_adam(st.wts, grad_fn, carry0, self.step_sizes, xs=xs,
                               bias_corrections=self._bc(st.wts))
        aux = self.sampler.fit_aux(carry) if self.lagged else carry
        return st._replace(wts=w_new, sampler_aux=aux)

    def _step_draws(self, st: CoresetState, draws: Draws, it: int):
        """(xs, draw) of a per-step or learn_beta pass: nn_adam's per-step
        inputs and ``draw(w, aux, xs_i) -> (samples, aux, idx)``, idx the
        step's shard-local subsample (None: every local row). Pre-drawn
        noise and indices ride in ``xs``; a sampler without a noise split
        is called on the replicated generator, then the subsample drawn."""
        smp, n_opt = self.sampler, self.n_opt
        if self.per_step_draws:
            def draw(w, aux, xs_i):
                samples, aux = smp(draws.replicated, self.S, w, st.pts, aux)
                return samples, aux, None if n_opt is None else draws.local_indices(n_opt)

            return None, draw
        z_all, idx_all = draws.optimize(it, st)

        def draw(w, aux, xs_i):
            samples, aux = smp.from_noise(xs_i[0], w, st.pts, aux)
            return samples, aux, None if idx_all is None else xs_i[1]

        return ((z_all,) if idx_all is None else (z_all, idx_all)), draw

    def _rows(self, idx):
        """(rows, their weights or None, their mask, the target's scale) of
        a step's subsample, or of every local row when ``idx`` is None."""
        if idx is None:
            return self.data, self.u, self.row_valid[:, None], None
        return (self.data[idx], None if self.u is None else self.u[idx], self.has_rows,
                self.opt_scale)

    def _optimize_per_step(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """Full-data refinement (reference sharded.py:442-451), or a
        sampler without a noise split: every step refits the posterior
        (the sampler draws from the refit), projects its rows (every local
        row, or its subsample) and the buffer, and takes the target: exact
        over every row, or the stratified estimate."""
        S, mesh = self.S, self.mesh
        xs, draw = self._step_draws(st, draws, it)
        mask = st.slot_mask[:, None].to(self.data.dtype)

        def grad_fn(w, aux, i, xs_i=None):
            samples, aux, idx = draw(w, aux, xs_i)
            rows, usub, valid, scale = self._rows(idx)
            vecs, corevecs = self._project([rows, st.pts], self._samples_loc(samples), st.beta)
            total = self._target(vecs * valid, usub, scale)
            corevecs = corevecs * mask
            resid = total - w @ corevecs
            return -mesh.psum(corevecs @ resid, SAMP_AXIS) / S, aux

        w_new, aux = nn_adam(st.wts, grad_fn, st.sampler_aux, self.step_sizes, xs=xs,
                             bias_corrections=self._bc(st.wts))
        return st._replace(wts=w_new, sampler_aux=aux)

    def _optimize_learn_beta(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """The joint (w, beta) refinement, replicated (reference
        sharded.py:460-477): beta clamped to [1e-3, beta_cap] inside the
        gradient and after the pass; the rows and the buffer projected
        separately, the buffer with its centred beta-gradient; one psum
        over ``samp`` centres all three blocks and one more takes both
        inner products over S."""
        cfg, S, mesh = self.config, self.S, self.mesh
        xs, draw = self._step_draws(st, draws, it)
        M_buf = st.wts.shape[0]
        mask = st.slot_mask[:, None].to(self.data.dtype)
        clamp = lambda b: torch.clamp(b, BETA_FLOOR, cfg.beta_cap)

        def grad_fn(x, aux, i, xs_i=None):
            w, beta = x[:M_buf], clamp(x[M_buf])
            samples, aux, idx = draw(w, aux, xs_i)
            samples_loc = self._samples_loc(samples)
            rows, usub, valid, scale = self._rows(idx)
            lls = [self._lik(rows, samples_loc, beta), self._lik(st.pts, samples_loc, beta),
                   self.model.beta_gradient(st.pts, samples_loc, beta)]
            sums = mesh.psum(torch.cat([v.sum(dim=1) for v in lls]), SAMP_AXIS)
            means = torch.split(sums / S, [v.shape[0] for v in lls])
            vecs, corevecs, betagrads = (v - mu[:, None] for v, mu in zip(lls, means))
            corevecs, betagrads = corevecs * mask, betagrads * mask
            total = self._target(vecs * valid, usub, scale)
            resid = total - w @ corevecs
            dots = mesh.psum(torch.cat([corevecs @ resid, betagrads @ resid]), SAMP_AXIS)
            betagrad = -cfg.beta_grad_scale * (w @ dots[M_buf:]) / S
            return torch.cat([-dots[:M_buf] / S, betagrad.reshape(1)]), aux

        x0 = torch.cat([st.wts, st.beta.reshape(1)])
        x, aux = nn_adam(x0, grad_fn, st.sampler_aux, self.step_sizes, xs=xs,
                         bias_corrections=self._bc(x0))
        return st._replace(wts=x[:M_buf], beta=clamp(x[M_buf]), sampler_aux=aux)

    def build(self, st: CoresetState, itrs: int, draws: Draws) -> CoresetState:
        for it in range(itrs):
            st = self.optimize(self.select(st, draws, it), draws, it)
        return st

    def build_trace(self, st: CoresetState, itrs: int, draws: Draws):
        """(state, (wts, idcs, beta)) with each stacked over iterations."""
        trace = []
        for it in range(itrs):
            st = self.optimize(self.select(st, draws, it), draws, it)
            trace.append((st.wts, st.idcs, st.beta))
        return st, tuple(torch.stack(x) for x in zip(*trace))


def make_sharded_incremental_builder(
    data_local: torch.Tensor,
    n_true: int,
    model,
    sampler,
    config: IncrementalConfig,
    mesh: Mesh,
    step_sizes: Optional[torch.Tensor] = None,
    data_weights: Optional[torch.Tensor] = None,
    graph: Optional[bool] = None,
) -> ShardedIncrementalBuilder:
    """The builder of this rank over its row block ``data_local`` of an
    (n_true, D) dataset (``shard_data``'s output; zero rows pad N to a
    multiple of the data-axis size). ``data_weights`` is this rank's block
    of (N,) base-data weights (``shard_weights``): row n counts u_n times
    in the target, and zero-weight rows are never selected. A sampler
    with ``draw_noise``/``from_noise`` (the Laplace, conjugate, fixed and
    prior samplers) has its noise drawn per pass, one without (the NIW
    sampler) is called inside each step (route "per_step");
    ``fit``/``from_fit``/``fit_aux`` serve lagged refits; ``learn_beta``
    needs a model with
    ``beta_gradient``. ``graph``: whether the fused route's passes run as
    replayed CUDA graphs (None: on a CUDA device; True elsewhere raises)."""
    n_data, n_samp = require_axes(mesh)
    if not noise_split(sampler) and not callable(sampler):
        raise ValueError("the sampler has neither a noise split (draw_noise, from_noise) "
                         "nor a call sampler(generator, n, wts, pts, aux)")
    if config.learn_beta and getattr(model, "beta_gradient", None) is None:
        raise ValueError("learn_beta requires a model with beta_gradient")
    S = config.projection_dim
    if S % n_samp:
        raise ValueError(f"projection_dim {S} must divide over samp axis {n_samp}")
    if data_weights is not None:
        if tuple(data_weights.shape) != (data_local.shape[0],):
            raise ValueError(f"data_weights must be ({data_local.shape[0]},) (padded "
                             f"like the rows: use shard_weights), got "
                             f"{tuple(data_weights.shape)}")
        data_weights = data_weights.to(dtype=data_local.dtype, device=data_local.device)
    require_lagged_fit(sampler, config)
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data_local.dtype,
                                   device=data_local.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data_local.dtype,
                                 device=data_local.device)
    return ShardedIncrementalBuilder(data_local, n_true, model, sampler, config, mesh,
                                     step_sizes, data_weights, graph)
