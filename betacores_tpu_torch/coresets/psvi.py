"""Incremental pseudo-coreset (PSVI) (counterpart of
betacores_tpu/coresets/psvi.py).

SparseVI's greedy skeleton, where each refinement moves the weights AND
the selected points' locations together (BPSVI's joint update inside
SparseVI's loop). Select guards only against duplicates: there is no
take-new comparison against the existing slots, because the moved
pseudo-points would out-score any fresh candidate and block growth. The
refinement is BPSVI's ``JointPass`` over the buffer, the slot mask as its
active mask, replayed as CUDA graphs on a CUDA device (``graph``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.projection import project_ll
from ..utils.device import resolve_device
from ..utils.graphs import PassRunner, resolve_graph
from ..utils.opt import step_schedule
from ..utils.prng import KeySequence
from . import state as state_lib
from .api import _as_data, _steps_to_i0
from .bpsvi import RowsPass
from .incremental import GeneratorDraws, IncrementalConfig, noise_split
from .state import CoresetState


class PSVIBuilder:
    """``build(state, itrs, draws)`` runs itrs x (select + joint
    refinement); draws as the incremental builder's (``GeneratorDraws``,
    ``FixedDraws``)."""

    def __init__(self, data, model, sampler, config: IncrementalConfig, step_sizes,
                 graph: Optional[bool]):
        N = data.shape[0]
        self.data, self.model, self.sampler, self.config = data, model, sampler, config
        self.projection_dim = config.projection_dim
        self.n_sel = None if config.n_subsample_select is None else min(
            N, config.n_subsample_select)
        self.n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
        self.step_sizes = step_sizes
        self.u = None
        self.graph = resolve_graph(graph, data.device)
        self._pass: Optional[RowsPass] = None

    def generator_draws(self, generator: torch.Generator) -> GeneratorDraws:
        return GeneratorDraws(generator, self.sampler, self.data.shape[0], self.n_sel,
                              self.n_opt, self.step_sizes.shape[0], self.projection_dim)

    def select(self, st: CoresetState, draws, it: int = 0) -> CoresetState:
        data, S = self.data, self.projection_dim
        z, sub_idcs = draws.select(it, st)
        samples, aux = self.sampler.from_noise(z, st.wts, st.pts, st.sampler_aux)
        if sub_idcs is None:
            vecs, scaling = project_ll(self.model, data, samples), 1.0
        else:
            vecs = project_ll(self.model, data[sub_idcs], samples)
            scaling = data.shape[0] / self.n_sel
        mask = st.slot_mask
        corevecs = project_ll(self.model, st.pts, samples) * mask[:, None].to(data.dtype)
        resid = scaling * vecs.sum(dim=0) - st.wts @ corevecs
        vn = torch.sqrt(torch.sum(vecs * vecs, dim=1))
        vn = torch.where(vn > 0, vn, torch.inf)
        corrs = (vecs @ resid) / vn / S
        # the duplicate guard only: a row already used as an initializer
        # would give identical gradients forever
        fcand = torch.argmax(corrs).reshape(1)
        f = fcand if sub_idcs is None else sub_idcs.index_select(0, fcand)
        M_max = st.wts.shape[0]
        already = torch.any((st.idcs == f) & mask)
        add = ~already & (st.m < M_max)
        slot = torch.clamp(st.m, max=M_max - 1)
        put = (torch.arange(M_max, device=st.m.device) == slot) & add
        return st._replace(idcs=torch.where(put, f.to(torch.int32), st.idcs),
                           pts=torch.where(put[:, None], data.index_select(0, f), st.pts),
                           m=st.m + add.to(torch.int32), sampler_aux=aux)

    def optimize(self, st: CoresetState, draws, it: int = 0) -> CoresetState:
        """Joint projected Adam over the buffer's weights and locations,
        padding slots held at weight 0."""
        z_all, idx_all = draws.optimize(it, st)
        M = st.wts.shape[0]
        p = self._pass
        if p is None or not p.serves(M, z_all, st.sampler_aux):
            p = self._pass = RowsPass(self, M, z_all, st.sampler_aux, PassRunner(self.graph))
        p.fill(st.wts, st.pts, st.slot_mask.to(st.wts.dtype), st.sampler_aux, z_all)
        p.fill_rows(idx_all)
        p.run()
        wts, pts = p.result()
        return st._replace(wts=wts, pts=pts, sampler_aux=p.carry.clone())

    def build(self, st: CoresetState, itrs: int, draws) -> CoresetState:
        for it in range(itrs):
            st = self.optimize(self.select(st, draws, it), draws, it)
        return st


def make_psvi_builder(data: torch.Tensor, model, sampler, config: IncrementalConfig,
                      step_sizes: Optional[torch.Tensor] = None,
                      graph: Optional[bool] = None) -> PSVIBuilder:
    """The PSVI builder over ``data`` (N, D) on its device. Needs
    ``model.grad_z_log_likelihood`` and a sampler with a noise split;
    the KL projection only (``use_beta``/``learn_beta`` refused)."""
    if getattr(model, "grad_z_log_likelihood", None) is None:
        raise ValueError("PSVI needs model.grad_z_log_likelihood")
    if config.use_beta or config.learn_beta:
        raise ValueError("PSVI is KL-projection only; use_beta/learn_beta are not "
                         "supported (pass a plain BlackBoxProjector)")
    if not noise_split(sampler):
        raise ValueError("PSVI draws a pass's noise ahead: the sampler needs "
                         "draw_noise and from_noise")
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return PSVIBuilder(data, model, sampler, config, step_sizes, graph)


class PseudoSparseVICoreset:
    """The eager object (the class the reference intends): ``build(itrs,
    sz)``, ``get()``, ``size()``. Runs on the card unless given
    ``device="cpu"``."""

    def __init__(self, data, ll_projector, n_subsample_select=None, n_subsample_opt=None,
                 opt_itrs: int = 100, step_sched: Callable = lambda i: 1.0 / (1.0 + i),
                 seed: int = 0, max_size: int = 64, device=None,
                 graph: Optional[bool] = None):
        self.device = resolve_device(device)
        self.data = _as_data(data, self.device)
        steps = torch.from_numpy(_steps_to_i0(step_sched, opt_itrs))
        cfg = IncrementalConfig(projection_dim=ll_projector.projection_dimension,
                                n_subsample_select=n_subsample_select,
                                n_subsample_opt=n_subsample_opt, opt_itrs=opt_itrs)
        self._builder = make_psvi_builder(self.data, ll_projector.model, ll_projector.sampler,
                                          cfg, step_sizes=steps, graph=graph)
        self.keys = KeySequence(seed, self.device)
        td = getattr(ll_projector, "theta_dim", None)
        self.state = state_lib.init_state(
            max_size, self.data.shape[1], dtype=self.data.dtype, device=self.device,
            sampler_aux=torch.zeros(td or self.data.shape[1], dtype=self.data.dtype,
                                    device=self.device))

    def _draws(self, itrs: int):
        """The draws of one ``build``: from the next generator of this
        instance's key sequence."""
        return self._builder.generator_draws(self.keys())

    def build(self, itrs: int, sz: int) -> None:
        if int(self.state.m) + itrs > sz:
            raise ValueError("PseudoSparseVICoreset.build(): size overrun")
        self.state = self._builder.build(self.state, int(itrs), self._draws(int(itrs)))

    def get(self):
        return state_lib.get(self.state)

    def size(self) -> int:
        return int((self.state.wts > 0).sum())
