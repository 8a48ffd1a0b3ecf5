"""Incremental greedy beta-Cores / SparseVI builder (counterpart of
betacores_tpu/coresets/incremental.py).

Each iteration runs

  select:   fit the Laplace posterior of the current coreset, draw S samples,
            project the data (every row, or a subsample) and the coreset
            buffer into the tangent space, score candidates by correlation
            with the residual resid = scaling * sum_n v_n - w . corevecs and
            install the best (reference parity, or ``dedup_select``);
  optimize: ``opt_itrs`` projected-Adam steps of the Monte-Carlo KL gradient
            on pre-drawn noise and subsample rows, each refitting the
            posterior (warm-started Newton, or every k-th step with
            ``refit_every``). A model with a fused step (logistic
            regression) on an unweighted build runs each step as ONE
            launch (ops/kernels.py::logreg_adam_step: a CUDA kernel on the
            card, its plain version on the CPU); any other model, or a
            weighted build, takes the composed route through
            utils/opt.py::nn_adam. Full-data refinement
            (``n_subsample_opt=None``) projects every row at each step.

``data_weights`` (N,) makes row n count u_n times in the residual target
scaling * sum_n u_n v_n; zero-weight rows are never selected.

Projections of at least FUSED_MIN_ROWS rows go to the model's fused
projection (ops/projection.py), e.g. the multiclass kernel K2 in
full-candidate select.

Random draws are separated from compute: ``build`` takes a draws provider
(``GeneratorDraws`` draws from a ``torch.Generator``; ``FixedDraws``
replays given tensors, e.g. the JAX package's own draws). Python loops take
the place of ``lax.scan``; no loop body reads a device value on the host,
so the step loop stays capturable as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence, Tuple

import torch

from ..ops.kernels import (adam_sclr_stack, make_refit_state, make_step_refit,
                           maybe_fused, pack_fused_step_rows, pad_fused_step_noise)
from ..ops.projection import draw_subsample, project_beta, project_ll
from ..utils.opt import nn_adam, step_schedule
from .state import CoresetState


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    """Build configuration (the reference's constructor kwargs)."""

    projection_dim: int = 100          # S
    n_subsample_select: Optional[int] = None
    n_subsample_opt: Optional[int] = None
    opt_itrs: int = 100
    i0: float = 0.1                    # lr schedule i0 / (1 + i)
    use_beta: bool = False             # project with the beta-likelihood
    learn_beta: bool = False           # not ported: raises
    # True: mask already-selected rows out of the candidate argmax and always
    # install the best remaining candidate. False: reference parity (a
    # duplicate argmax, or an existing point out-scoring every candidate,
    # adds nothing).
    dedup_select: bool = False
    # refit the posterior only every k-th refinement step, reusing the last
    # fit for the steps between
    refit_every: int = 1

    def __post_init__(self):
        if self.learn_beta and not self.use_beta:
            raise ValueError("learn_beta requires use_beta=True")
        if self.refit_every < 1:
            raise ValueError("refit_every must be >= 1")


def _target_sum(vecs, usub):
    """sum_n u_n v_n over already-gathered rows (u None: the plain sum)."""
    return vecs.sum(dim=0) if usub is None else usub @ vecs


class Draws(Protocol):
    """Source of a build's random draws. ``it`` counts selections from 0
    within one ``build`` call."""

    def select(self, it: int, st: CoresetState) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(z_sel (S, d) standard normals, idx_sel (n_sel,) row indices, or
        None when select scores every row)."""

    def optimize(self, it: int, st: CoresetState) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(z_all (T, S, d), idx_all (T, n_opt), or None when the refinement
        projects every row) for a whole refinement pass."""


@dataclasses.dataclass
class GeneratorDraws:
    """Draws from one ``torch.Generator``, on the generator's device."""

    generator: torch.Generator
    sampler: object
    n_total: int
    n_sel: Optional[int]              # None: select scores every row
    n_opt: Optional[int]              # None: refinement projects every row
    n_steps: int
    n_samples: int

    def select(self, it, st):
        z = self.sampler.draw_noise(self.generator, self.n_samples, st.wts,
                                    st.pts, st.sampler_aux)
        if self.n_sel is None:
            return z, None
        idx, _ = draw_subsample(self.generator, self.n_total, self.n_sel)
        return z, idx

    def optimize(self, it, st):
        T, S = self.n_steps, self.n_samples
        z = self.sampler.draw_noise(self.generator, T * S, st.wts, st.pts,
                                    st.sampler_aux).reshape(T, S, -1)
        if self.n_opt is None:
            return z, None
        idx, _ = draw_subsample(self.generator, self.n_total, T * self.n_opt)
        return z, idx.reshape(T, self.n_opt)


@dataclasses.dataclass
class FixedDraws:
    """Replays given draws: ``sel[it] = (z_sel, idx_sel or None)`` and
    ``opt[it] = (z_all, idx_all or None)``, moved to the state's device."""

    sel: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]
    opt: Sequence[Tuple[torch.Tensor, torch.Tensor]]

    def select(self, it, st):
        z, idx = self.sel[it]
        dev = st.wts.device
        return z.to(dev), None if idx is None else idx.to(dev)

    def optimize(self, it, st):
        z, idx = self.opt[it]
        dev = st.wts.device
        return z.to(dev), None if idx is None else idx.to(dev)


class IncrementalBuilder:
    """``build(state, itrs, draws)`` runs itrs x (select + optimize);
    ``build_trace`` also returns each iteration's (wts, idcs, beta);
    ``select`` / ``optimize`` run one half-iteration."""

    def __init__(self, data, model, sampler, config: IncrementalConfig,
                 step_sizes: torch.Tensor, data_weights: Optional[torch.Tensor] = None):
        self.data = data
        self.model = model
        self.sampler = sampler
        self.config = config
        self.step_sizes = step_sizes
        self.u = data_weights
        N = data.shape[0]
        self.n_sel = (None if config.n_subsample_select is None
                      else min(N, config.n_subsample_select))
        self.n_opt = (None if config.n_subsample_opt is None
                      else min(N, config.n_subsample_opt))
        # the fused step serves a subsampled, unweighted refinement
        self.fstep = (None if self.n_opt is None or data_weights is not None
                      else getattr(model, "fused_beta_grad_step" if config.use_beta
                                   else "fused_ll_grad_step", None))
        # (T, 3) per-step Adam scalars of the fused step, fixed per build
        self.sclr_all = None if self.fstep is None else adam_sclr_stack(step_sizes)

    def generator_draws(self, generator: torch.Generator) -> GeneratorDraws:
        """The default draws provider for this build."""
        return GeneratorDraws(generator, self.sampler, self.data.shape[0],
                              self.n_sel, self.n_opt, self.step_sizes.shape[0],
                              self.config.projection_dim)

    def _project(self, pts, samples, beta):
        if self.config.use_beta:
            return project_beta(self.model, pts, samples, beta)
        return project_ll(self.model, pts, samples)

    def _joint_rows_identical(self, n_rows_joint: int) -> bool:
        """True when projecting [subsample; coreset buffer] as ONE block
        equals two separate calls. Centring is per row, so only routing can
        differ: a joint block may cross FUSED_MIN_ROWS where the buffer's
        own call never would, and move the coreset rows onto the kernel."""
        field = ("fused_beta_projection" if self.config.use_beta
                 else "fused_ll_projection")
        return getattr(self.model, field, None) is None or not maybe_fused(n_rows_joint)

    def _tangent(self, rows, st: CoresetState, samples, joint: bool):
        """(vecs, corevecs): the centred projections of ``rows`` and of the
        coreset buffer, padding slots zeroed. With ``joint``, ``rows`` ends
        with the buffer and is projected as one block."""
        mask = st.slot_mask[:, None].to(self.data.dtype)
        if joint:
            n = rows.shape[0] - st.pts.shape[0]
            allvecs = self._project(rows, samples, st.beta)
            return allvecs[:n], allvecs[n:] * mask
        return (self._project(rows, samples, st.beta),
                self._project(st.pts, samples, st.beta) * mask)

    def select(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference bcores.py:74-90 / sparsevi.py:74-96."""
        data, S, n_sel = self.data, self.config.projection_dim, self.n_sel
        z, sub_idcs = draws.select(it, st)
        samples, aux = self.sampler.from_noise(z, st.wts, st.pts, st.sampler_aux)
        slot_mask = st.slot_mask
        if n_sel is None:
            # every row is a candidate: the data and the buffer project
            # separately, so the data block alone decides the routing
            scaling, rows, joint = 1.0, data, False
        else:
            scaling, rows = data.shape[0] / n_sel, data[sub_idcs]
            joint = self._joint_rows_identical(n_sel + st.pts.shape[0])
            if joint:
                rows = torch.cat([rows, st.pts])
        vecs, corevecs = self._tangent(rows, st, samples, joint)
        usub = None if self.u is None else (self.u if sub_idcs is None else self.u[sub_idcs])
        resid = scaling * _target_sum(vecs, usub) - st.wts @ corevecs
        vn = torch.sqrt(torch.sum(vecs * vecs, dim=1))
        vn = torch.where(vn > 0, vn, torch.inf)  # zero projections score 0
        corrs = (vecs @ resid) / vn / S
        if usub is not None:
            # zero-weight rows add nothing to the target: never selectable
            corrs = torch.where(usub > 0, corrs, -torch.inf)
        M_max = st.wts.shape[0]
        if self.config.dedup_select:
            # scatter the live slots' rows into an (N,) hit count and mask
            # them out of the candidates; a padding slot (index -1, mask 0)
            # adds 0 at row 0
            hits = torch.zeros(data.shape[0], dtype=torch.int32, device=data.device)
            hits.scatter_add_(0, st.idcs.clamp_min(0).to(torch.int64),
                              slot_mask.to(torch.int32))
            cand_hit = hits if sub_idcs is None else hits[sub_idcs]
            corrs = torch.where(cand_hit > 0, -torch.inf, corrs)
        fcand = torch.argmax(corrs).reshape(1)
        f = fcand if sub_idcs is None else sub_idcs.index_select(0, fcand)
        if self.config.dedup_select:
            add = (st.m < M_max) & torch.isfinite(corrs.index_select(0, fcand)[0])
        else:
            cn = torch.sqrt(torch.sum(corevecs * corevecs, dim=1))
            cn = torch.where(cn > 0, cn, torch.inf)
            corecorrs = torch.where(slot_mask, torch.abs(corevecs @ resid) / cn / S,
                                    -torch.inf)
            take_new = (st.m == 0) | (corrs.index_select(0, fcand)[0] > corecorrs.max())
            already = torch.any((st.idcs == f) & slot_mask)
            add = take_new & ~already & (st.m < M_max)
            if self.u is not None:
                # the m == 0 arm bypasses the -inf mask: never install a
                # zero-weight row
                add = add & torch.isfinite(corrs.index_select(0, fcand)[0])
        slot = torch.clamp(st.m, max=M_max - 1)
        put = (torch.arange(M_max, device=st.m.device) == slot) & add
        return st._replace(
            idcs=torch.where(put, f.to(torch.int32), st.idcs),
            pts=torch.where(put[:, None], data.index_select(0, f), st.pts),
            m=st.m + add.to(torch.int32),
            sampler_aux=aux)

    def optimize(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference bcores.py:126-150 on pre-drawn noise and subsample rows:
        through the model's fused step when it serves the build, else
        composed; full-data refinement projects every row per step."""
        if self.n_opt is None:
            return self._optimize_full(st, draws, it)
        if self.fstep is None:
            return self._optimize_composed(st, draws, it)
        return self._optimize_fused(st, draws, it)

    def _optimize_full(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """Full-data refinement (reference incremental.py:498-505): each step
        refits the posterior, projects every row and the buffer separately,
        and takes the exact target sum_n u_n v_n."""
        smp, S = self.sampler, self.config.projection_dim
        z_all, _ = draws.optimize(it, st)

        def grad_fn(w, aux, i, xs_i):
            samples, aux = smp.from_noise(xs_i[0], w, st.pts, aux)
            vecs, corevecs = self._tangent(self.data, st, samples, joint=False)
            resid = _target_sum(vecs, self.u) - w @ corevecs
            return -(corevecs @ resid) / S, aux

        w_new, aux = nn_adam(st.wts, grad_fn, st.sampler_aux, self.step_sizes, xs=(z_all,))
        return st._replace(wts=w_new, sampler_aux=aux)

    def _optimize_composed(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """The composed route (reference incremental.py:430-496): per step
        the sampler turns the step's noise into samples (refitting the
        posterior, or every k-th step with ``refit_every``), the subsample
        and the buffer are projected, and nn_adam takes the gradient
        -(corevecs @ resid) / S."""
        cfg, data, smp = self.config, self.data, self.sampler
        S, n_opt = cfg.projection_dim, self.n_opt
        z_all, idx_all = draws.optimize(it, st)
        T, M_buf = self.step_sizes.shape[0], st.pts.shape[0]
        rows_all = data[idx_all]                                 # (T, n_opt, D)
        u_all = None if self.u is None else self.u[idx_all]      # (T, n_opt)
        scaling = data.shape[0] / n_opt
        joint = self._joint_rows_identical(n_opt + M_buf)
        if joint:
            # the buffer is constant over the pass: append it to every
            # step's rows once, outside the loop
            rows_all = torch.cat([rows_all, st.pts.expand(T, *st.pts.shape)], dim=1)
        lagged = cfg.refit_every > 1
        if lagged:
            k_refit = cfg.refit_every

            def samples_at(w, lap, z, i):
                if i % k_refit == 0 and i > 0:
                    lap = smp.fit(w, st.pts, smp.fit_aux(lap))
                return smp.from_fit(lap, z), lap

            carry0 = smp.fit(st.wts, st.pts, st.sampler_aux)
        else:
            def samples_at(w, aux, z, i):
                return smp.from_noise(z, w, st.pts, aux)

            carry0 = st.sampler_aux

        def grad_fn(w, carry, i, xs_i):
            z, rows = xs_i[:2]
            samples, carry = samples_at(w, carry, z, i)
            vecs, corevecs = self._tangent(rows, st, samples, joint)
            usub = xs_i[2] if len(xs_i) > 2 else None
            resid = scaling * _target_sum(vecs, usub) - w @ corevecs
            return -(corevecs @ resid) / S, carry

        xs = (z_all, rows_all) if u_all is None else (z_all, rows_all, u_all)
        w_new, carry = nn_adam(st.wts, grad_fn, carry0, self.step_sizes, xs=xs)
        aux = smp.fit_aux(carry) if lagged else carry
        return st._replace(wts=w_new, sampler_aux=aux)

    def _optimize_fused(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """The fused-step route: the pass's noise and subsample rows are
        drawn and packed once, then each step is one Newton refit plus one
        fused step."""
        cfg, data = self.config, self.data
        S, n_opt = cfg.projection_dim, self.n_opt
        f32 = torch.float32
        z_all, idx_all = draws.optimize(it, st)
        T = self.step_sizes.shape[0]
        M_buf = st.pts.shape[0]
        xin_all, M_pad, _ = pack_fused_step_rows(data[idx_all], st.pts,
                                                 st.slot_mask, n_opt)
        z_pad = pad_fused_step_noise(z_all, S)
        # full(), not tensor(): a host-to-device copy would synchronise
        scaling = torch.full((), data.shape[0] / n_opt, dtype=data.dtype,
                             device=data.device)
        sc = torch.stack([st.beta.to(f32), scaling.to(f32)])
        lagged = cfg.refit_every > 1
        fit_aux = self.sampler.fit_aux
        refit_state = make_refit_state(self.sampler, st.pts)
        step_refit = make_step_refit(refit_state, lagged, cfg.refit_every,
                                     fit_aux, M_buf, data.dtype)
        w = torch.zeros((1, M_pad), dtype=f32, device=data.device)
        w[0, :M_buf] = st.wts.to(f32)
        m1 = torch.zeros_like(w)
        m2 = torch.zeros_like(w)
        lap_c = refit_state(st.wts, st.sampler_aux) if lagged else st.sampler_aux
        for i in range(T):
            lap, linv = step_refit(w, i, lap_c)
            w, m1, m2 = self.fstep(xin_all[i], z_pad[i], lap.mu.to(f32)[None, :],
                                   linv, w, m1, m2, sc, self.sclr_all[i], S)
            lap_c = (lap, linv) if lagged else fit_aux(lap)
        aux = fit_aux(lap_c[0]) if lagged else lap_c
        return st._replace(wts=w[0, :M_buf].to(st.wts.dtype), sampler_aux=aux)

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


def make_incremental_builder(
    data: torch.Tensor,
    model,
    sampler,
    config: IncrementalConfig,
    step_sizes: Optional[torch.Tensor] = None,
    data_weights: Optional[torch.Tensor] = None,
) -> IncrementalBuilder:
    """The builder over ``data`` (N, D): select over every row or a
    subsample, refinement on a subsample or every row, a Laplace-family
    sampler, optional (N,) base-data weights ``data_weights``. A subsampled,
    unweighted refinement takes the model's fused step when it has one
    (with the sampler's ``fit`` and ``fit_aux``; ``fit_inv`` when present),
    else the composed route (with ``fit``, ``from_fit`` and ``fit_aux`` for
    lagged refits). ``learn_beta``, or a sampler the route cannot use,
    raises NotImplementedError rather than taking another route."""
    if config.learn_beta:
        raise NotImplementedError("learn_beta is not ported yet")
    N = data.shape[0]
    if data_weights is not None:
        if tuple(data_weights.shape) != (N,):
            raise ValueError(f"data_weights must be ({N},), got "
                             f"{tuple(data_weights.shape)}")
        data_weights = data_weights.to(dtype=data.dtype, device=data.device)
    field = "fused_beta_grad_step" if config.use_beta else "fused_ll_grad_step"
    # full-data refinement refits every step through from_noise
    needs = ["draw_noise", "from_noise"]
    if config.n_subsample_opt is not None:
        if getattr(model, field, None) is not None and data_weights is None:
            needs += ["fit", "fit_aux"]
        elif config.refit_every > 1:
            needs += ["fit", "from_fit", "fit_aux"]
    for name in needs:
        if getattr(sampler, name, None) is None:
            raise NotImplementedError(f"sampler lacks {name}: only Laplace-family "
                                      "samplers are ported")
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return IncrementalBuilder(data, model, sampler, config, step_sizes, data_weights)
