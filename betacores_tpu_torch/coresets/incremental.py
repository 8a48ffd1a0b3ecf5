"""Incremental greedy beta-Cores / SparseVI builder (counterpart of
betacores_tpu/coresets/incremental.py).

Each iteration runs

  select:   fit the Laplace posterior of the current coreset, draw S samples,
            project a data subsample and the coreset buffer into the tangent
            space, score candidates by correlation with the residual
            resid = scaling * sum_n v_n - w . corevecs and install the best
            (reference parity, or ``dedup_select``);
  optimize: ``opt_itrs`` projected-Adam steps of the Monte-Carlo KL gradient,
            each refitting the posterior (warm-started Newton, or every k-th
            step with ``refit_every``) and running ONE fused step
            (ops/kernels.py::logreg_adam_step: a CUDA kernel on the card,
            its plain twin on the CPU).

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
                           pack_fused_step_rows, pad_fused_step_noise)
from ..ops.projection import draw_subsample, project_beta, project_ll
from ..utils.opt import step_schedule
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


class Draws(Protocol):
    """Source of a build's random draws. ``it`` counts selections from 0
    within one ``build`` call."""

    def select(self, it: int, st: CoresetState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_sel (S, d) standard normals, idx_sel (n_sel,) row indices)."""

    def optimize(self, it: int, st: CoresetState) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z_all (T, S, d), idx_all (T, n_opt)) for a whole refinement pass."""


@dataclasses.dataclass
class GeneratorDraws:
    """Draws from one ``torch.Generator``, on the generator's device."""

    generator: torch.Generator
    sampler: object
    n_total: int
    n_sel: int
    n_opt: int
    n_steps: int
    n_samples: int

    def select(self, it, st):
        z = self.sampler.draw_noise(self.generator, self.n_samples, st.wts,
                                    st.pts, st.sampler_aux)
        idx, _ = draw_subsample(self.generator, self.n_total, self.n_sel)
        return z, idx

    def optimize(self, it, st):
        T, S = self.n_steps, self.n_samples
        z = self.sampler.draw_noise(self.generator, T * S, st.wts, st.pts,
                                    st.sampler_aux)
        idx, _ = draw_subsample(self.generator, self.n_total, T * self.n_opt)
        return z.reshape(T, S, -1), idx.reshape(T, self.n_opt)


@dataclasses.dataclass
class FixedDraws:
    """Replays given draws: ``sel[it] = (z_sel, idx_sel)`` and
    ``opt[it] = (z_all, idx_all)``, moved to the state's device."""

    sel: Sequence[Tuple[torch.Tensor, torch.Tensor]]
    opt: Sequence[Tuple[torch.Tensor, torch.Tensor]]

    def select(self, it, st):
        z, idx = self.sel[it]
        return z.to(st.wts.device), idx.to(st.wts.device)

    def optimize(self, it, st):
        z, idx = self.opt[it]
        return z.to(st.wts.device), idx.to(st.wts.device)


class IncrementalBuilder:
    """``build(state, itrs, draws)`` runs itrs x (select + optimize);
    ``build_trace`` also returns each iteration's (wts, idcs, beta);
    ``select`` / ``optimize`` run one half-iteration."""

    def __init__(self, data, model, sampler, config: IncrementalConfig,
                 step_sizes: torch.Tensor):
        self.data = data
        self.model = model
        self.sampler = sampler
        self.config = config
        self.step_sizes = step_sizes
        self.sclr_all = adam_sclr_stack(step_sizes)   # (T, 3), fixed per build
        N = data.shape[0]
        self.n_sel = min(N, config.n_subsample_select)
        self.n_opt = min(N, config.n_subsample_opt)
        self.fstep = (model.fused_beta_grad_step if config.use_beta
                      else model.fused_ll_grad_step)

    def generator_draws(self, generator: torch.Generator) -> GeneratorDraws:
        """The default draws provider for this build."""
        return GeneratorDraws(generator, self.sampler, self.data.shape[0],
                              self.n_sel, self.n_opt, self.step_sizes.shape[0],
                              self.config.projection_dim)

    def _project(self, pts, samples, beta):
        if self.config.use_beta:
            return project_beta(self.model, pts, samples, beta)
        return project_ll(self.model, pts, samples)

    def select(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference bcores.py:74-90 / sparsevi.py:74-96."""
        data, S, n_sel = self.data, self.config.projection_dim, self.n_sel
        z, sub_idcs = draws.select(it, st)
        samples, aux = self.sampler.from_noise(z, st.wts, st.pts, st.sampler_aux)
        scaling = data.shape[0] / n_sel
        slot_mask = st.slot_mask
        # one projection of [subsample; coreset buffer]: centring is per row
        allvecs = self._project(torch.cat([data[sub_idcs], st.pts]), samples, st.beta)
        vecs = allvecs[:n_sel]
        corevecs = allvecs[n_sel:] * slot_mask[:, None].to(data.dtype)
        resid = scaling * vecs.sum(dim=0) - st.wts @ corevecs
        vn = torch.sqrt(torch.sum(vecs * vecs, dim=1))
        vn = torch.where(vn > 0, vn, torch.inf)  # zero projections score 0
        corrs = (vecs @ resid) / vn / S
        M_max = st.wts.shape[0]
        if self.config.dedup_select:
            # candidates already in a live slot are masked out; padding slots
            # (index -1, slot_mask False) match nothing
            hit = (sub_idcs[:, None] == st.idcs[None, :]) & slot_mask[None, :]
            corrs = torch.where(hit.any(dim=1), -torch.inf, corrs)
            fcand = torch.argmax(corrs).reshape(1)
            f = sub_idcs.index_select(0, fcand)
            add = (st.m < M_max) & torch.isfinite(corrs.index_select(0, fcand)[0])
        else:
            cn = torch.sqrt(torch.sum(corevecs * corevecs, dim=1))
            cn = torch.where(cn > 0, cn, torch.inf)
            corecorrs = torch.where(slot_mask, torch.abs(corevecs @ resid) / cn / S,
                                    -torch.inf)
            fcand = torch.argmax(corrs).reshape(1)
            f = sub_idcs.index_select(0, fcand)
            take_new = (st.m == 0) | (corrs.index_select(0, fcand)[0] > corecorrs.max())
            already = torch.any((st.idcs == f) & slot_mask)
            add = take_new & ~already & (st.m < M_max)
        slot = torch.clamp(st.m, max=M_max - 1)
        put = (torch.arange(M_max, device=st.m.device) == slot) & add
        return st._replace(
            idcs=torch.where(put, f.to(torch.int32), st.idcs),
            pts=torch.where(put[:, None], data.index_select(0, f), st.pts),
            m=st.m + add.to(torch.int32),
            sampler_aux=aux)

    def optimize(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference bcores.py:126-150 on the pre-drawn fused-step route:
        the pass's noise and subsample rows are drawn and packed once, then
        each step is one Newton refit plus one fused step."""
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
    """The builder over ``data`` (N, D). Only the main path is ported:
    subsampled select and refinement, a Laplace-family sampler and a model
    with the fused step. Anything else raises NotImplementedError rather
    than taking another route."""
    if config.learn_beta:
        raise NotImplementedError("learn_beta is not ported yet")
    if data_weights is not None:
        raise NotImplementedError("data_weights is not ported yet")
    if config.n_subsample_select is None or config.n_subsample_opt is None:
        raise NotImplementedError("full-data select/refinement is not ported "
                                  "yet: set n_subsample_select and n_subsample_opt")
    for name in ("draw_noise", "from_noise", "fit_inv", "fit_aux"):
        if getattr(sampler, name, None) is None:
            raise NotImplementedError(f"sampler lacks {name}: only Laplace-family "
                                      "samplers are ported")
    field = "fused_beta_grad_step" if config.use_beta else "fused_ll_grad_step"
    if getattr(model, field, None) is None:
        raise NotImplementedError(f"model has no {field}: the fused step is the "
                                  "port's only refinement route")
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return IncrementalBuilder(data, model, sampler, config, step_sizes)
