"""Batch pseudo-coreset (BPSVI) builder (counterpart of
betacores_tpu/coresets/bpsvi.py).

One shot: the pseudo-points start as a without-replacement draw of sz rows
(drawn in proportion to u with ``data_weights``) with weights total / sz,
and projected Adam then moves the weights (clipped to >= 0) and the point
locations (free) together. The point gradients come from the model's
gradient in the data row; both projections are centred over the sample
axis.

A build is one refinement pass of ``opt_itrs`` steps over static buffers
(``JointPass``), replayed as CUDA graphs on a CUDA device as the
incremental builders' passes are (utils/graphs.py, ``graph``). Its draws
(the initial rows, each step's posterior noise and subsample) are made
before the pass, from a ``torch.Generator`` or replayed (``BPSVIDraws``).

``bpsvi_build_batch`` builds several sizes at once, where the reference
``vmap``s whole builds over padded lanes: here the lanes run one after the
other through one builder, each padded to ``max_size`` slots with its tail
masked out, so lane i equals the standalone masked build under lane i's
draws. PSVI (coresets/psvi.py) and DP-BPSVI (coresets/dpbpsvi.py) run
their refinement through the same ``JointPass``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ..ops.projection import draw_subsample, project_ll, project_ll_with_grad
from ..utils.graphs import PassRunner, resolve_graph
from ..utils.opt import adam_bias_corrections, adam_update, step_schedule
from .incremental import noise_split


@dataclasses.dataclass(frozen=True)
class BPSVIConfig:
    projection_dim: int = 100
    n_subsample_opt: Optional[int] = None
    opt_itrs: int = 100
    i0: float = 0.1


class BPSVIDraws(NamedTuple):
    """The draws of one BPSVI build: the initial rows (sz,), the pass's
    posterior noise (T, S, d) and its subsample rows (T, n_opt), or None
    when every step projects every row."""

    init_idcs: torch.Tensor
    z_all: torch.Tensor
    idx_all: Optional[torch.Tensor]


class JointPass:
    """The static buffers and the step body of one projected-Adam pass
    over x = [w (M,), pts (M * D,)]: the Adam carry, the sampler's warm
    start, the active-slot mask (padding slots get weight 0 and gradient
    0), the pass's pre-drawn noise and the step counter on the device.
    ``target(samples)`` gives the step's data term (the sum of the
    projected rows, and its scaling); a subclass keeps the buffers it
    reads."""

    def __init__(self, owner, M: int, z_like: torch.Tensor, aux: torch.Tensor,
                 runner: PassRunner):
        data = owner.data
        dt, dev, D = data.dtype, data.device, data.shape[1]
        self.owner, self.runner, self.M, self.D = owner, runner, M, D
        self.n_steps = owner.step_sizes.shape[0]
        self.x, self.m1, self.m2 = (torch.zeros(M + M * D, dtype=dt, device=dev)
                                    for _ in range(3))
        self.active = torch.zeros(M, dtype=dt, device=dev)
        self.nn_mask = torch.arange(M + M * D, device=dev) < M
        self.carry = torch.empty_like(aux)
        self.z_all = torch.empty_like(z_like)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        self.sclr = torch.cat([owner.step_sizes.to(dt)[:, None],
                               adam_bias_corrections(self.n_steps, dt, dev)], dim=1)
        self.like = (M, tuple(z_like.shape), z_like.dtype, aux.dtype, tuple(aux.shape))

    def serves(self, M: int, z_all: torch.Tensor, aux: torch.Tensor) -> bool:
        return self.like == (M, tuple(z_all.shape), z_all.dtype, aux.dtype, tuple(aux.shape))

    def fill(self, w0, pts0, active, aux0, z_all) -> None:
        M = self.M
        self.x[:M].copy_(w0)
        self.x[M:].copy_(pts0.reshape(-1))
        self.m1.zero_()
        self.m2.zero_()
        self.i.zero_()
        self.active.copy_(active)
        self.carry.copy_(aux0)
        self.z_all.copy_(z_all)

    def target(self, samples):
        raise NotImplementedError

    def _step(self, key) -> None:
        o, M, D = self.owner, self.M, self.D
        S = o.projection_dim
        act = self.active
        w = self.x[:M] * act
        p = self.x[M:].reshape(M, D)
        z = self.z_all.index_select(0, self.i)[0]
        samples, aux = o.sampler.from_noise(z, w, p, self.carry)
        self.carry.copy_(aux)
        tsum, scaling = self.target(samples)
        corevecs, pgrads = project_ll_with_grad(o.model, p, samples)
        corevecs = corevecs * act[:, None]
        resid = scaling * tsum - w @ corevecs
        wgrad = -(corevecs @ resid) / S
        ugrad = -torch.einsum("i,isd,s->id", w, pgrads, resid) / S
        g = torch.cat([wgrad * act, (ugrad * act[:, None]).reshape(-1)])
        sclr = self.sclr.index_select(0, self.i)[0]
        x, m1, m2 = adam_update(self.x, self.m1, self.m2, g, sclr[0], sclr[1], sclr[2],
                                self.nn_mask)
        self.x.copy_(x)
        self.m1.copy_(m1)
        self.m2.copy_(m2)
        self.i.add_(1)

    def run(self) -> None:
        self.runner.run_pass(self.n_steps, self._step)

    def result(self):
        """(weights (M,), points (M, D)) as tensors of their own, padding
        slots at weight 0."""
        M = self.M
        return (self.x[:M] * self.active).clone(), self.x[M:].reshape(M, self.D).clone()


class RowsPass(JointPass):
    """A joint pass whose data term is the (weighted) sum of the step's
    subsample rows' projections, scaled by N / n_opt, or of every row's
    (``n_opt`` None): BPSVI's and PSVI's."""

    def __init__(self, owner, M, z_like, aux, runner):
        super().__init__(owner, M, z_like, aux, runner)
        data, T, n_opt = owner.data, self.n_steps, owner.n_opt
        self.rows_all = self.u_all = None
        if n_opt is not None:
            self.rows_all = torch.empty((T, n_opt, data.shape[1]), dtype=data.dtype,
                                        device=data.device)
            if owner.u is not None:
                self.u_all = torch.empty((T, n_opt), dtype=data.dtype, device=data.device)

    def fill_rows(self, idx_all) -> None:
        o = self.owner
        if self.rows_all is not None:
            self.rows_all.copy_(o.data[idx_all])
            if self.u_all is not None:
                self.u_all.copy_(o.u[idx_all])

    def target(self, samples):
        o = self.owner
        if self.rows_all is None:
            vecs = project_ll(o.model, o.data, samples)
            return (vecs.sum(dim=0) if o.u is None else o.u @ vecs), 1.0
        rows = self.rows_all.index_select(0, self.i)[0]
        vecs = project_ll(o.model, rows, samples)
        if self.u_all is None:
            tsum = vecs.sum(dim=0)
        else:
            tsum = self.u_all.index_select(0, self.i)[0] @ vecs
        return tsum, o.data.shape[0] / o.n_opt


class BPSVIBuilder:
    """``build(draws, sz, aux0, size_mask=None) -> (wts, pts, init_idcs)``
    (also ``builder(...)``); ``draws`` is a ``torch.Generator`` on the
    data's device or a ``BPSVIDraws`` to replay. ``size_mask`` (bool
    (sz,)) deactivates padding slots, as the batch builder's lanes do."""

    def __init__(self, data, model, sampler, config: BPSVIConfig, step_sizes,
                 data_weights: Optional[torch.Tensor], graph: Optional[bool]):
        N = data.shape[0]
        self.data, self.model, self.sampler, self.config = data, model, sampler, config
        self.projection_dim = config.projection_dim
        self.n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
        self.step_sizes = step_sizes
        self.u = data_weights
        self.graph = resolve_graph(graph, data.device)
        # rows of positive weight: the without-replacement init draws from them
        self.n_pos = None if data_weights is None else int((data_weights > 0).sum())
        self._passes: dict = {}

    def draws(self, generator: torch.Generator, sz: int, aux0) -> BPSVIDraws:
        """The draws of one build of size ``sz`` from ``generator``: the
        initial rows, then the pass's noise, then its subsample rows."""
        data, N = self.data, self.data.shape[0]
        if self.u is None:
            init = torch.randperm(N, generator=generator, device=data.device)[:sz]
        else:
            init = torch.multinomial(self.u / self.u.sum(), sz, replacement=False,
                                     generator=generator)
        T, S = self.step_sizes.shape[0], self.projection_dim
        w = torch.zeros(sz, dtype=data.dtype, device=data.device)
        z = self.sampler.draw_noise(generator, T * S, w, data[:sz], aux0).reshape(T, S, -1)
        idx = None
        if self.n_opt is not None:
            idx = draw_subsample(generator, N, T * self.n_opt)[0].reshape(T, self.n_opt)
        return BPSVIDraws(init, z, idx)

    def build(self, draws, sz: int, aux0, size_mask: Optional[torch.Tensor] = None):
        if self.n_pos is not None and sz > self.n_pos:
            raise ValueError(f"BPSVI init: sz={sz} exceeds the {self.n_pos} rows with "
                             f"positive data_weights; shrink sz or drop dead rows")
        data, N = self.data, self.data.shape[0]
        dt, dev = data.dtype, data.device
        if isinstance(draws, torch.Generator):
            draws = self.draws(draws, sz, aux0)
        init, z_all, idx_all = (None if t is None else t.to(dev) for t in draws)
        active = (torch.ones(sz, dtype=torch.bool, device=dev) if size_mask is None
                  else size_mask.to(dev))
        act = active.to(dt)
        total = float(N) if self.u is None else self.u.sum()
        pts0 = data[init] * act[:, None]
        w0 = torch.where(active, total / act.sum(), 0.0).to(dt)
        aux0 = aux0.to(dev)
        p = self._passes.get(sz)
        if p is None or not p.serves(sz, z_all, aux0):
            p = self._passes[sz] = RowsPass(self, sz, z_all, aux0, PassRunner(self.graph))
        p.fill(w0, pts0, act, aux0, z_all)
        p.fill_rows(idx_all)
        p.run()
        wts, pts = p.result()
        return wts, pts, init

    __call__ = build


def make_bpsvi_builder(data: torch.Tensor, model, sampler, config: BPSVIConfig,
                       step_sizes=None, data_weights=None,
                       graph: Optional[bool] = None) -> BPSVIBuilder:
    """The BPSVI builder over ``data`` (N, D) on its device. ``step_sizes``
    overrides the i0 / (1 + i) schedule. ``data_weights`` (N,): row n
    counts u_n times in the target, and the init draws in proportion to u
    with total mass sum(u). The sampler needs a noise split
    (``draw_noise``/``from_noise``) and the model ``grad_z_log_likelihood``."""
    if getattr(model, "grad_z_log_likelihood", None) is None:
        raise ValueError("BPSVI needs model.grad_z_log_likelihood")
    if not noise_split(sampler):
        raise ValueError("BPSVI draws a pass's noise ahead: the sampler needs "
                         "draw_noise and from_noise")
    N = data.shape[0]
    if data_weights is not None:
        data_weights = torch.as_tensor(data_weights).to(dtype=data.dtype, device=data.device)
        if tuple(data_weights.shape) != (N,):
            raise ValueError(f"data_weights must be ({N},), got {tuple(data_weights.shape)}")
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return BPSVIBuilder(data, model, sampler, config, step_sizes, data_weights, graph)


def bpsvi_build_batch(builder: BPSVIBuilder, draws, sizes: Sequence[int], max_size: int,
                      aux0):
    """Coresets of every size in ``sizes``: lane i is a build of
    ``max_size`` slots with slots >= sizes[i] masked out. ``draws`` is a
    ``torch.Generator`` (each lane's draws made from it in lane order,
    before the first lane runs) or a sequence of one ``BPSVIDraws`` per
    lane. Returns (wts (L, max_size), pts (L, max_size, D), idcs
    (L, max_size)). The lanes run one after the other."""
    dev = builder.data.device
    if isinstance(draws, torch.Generator):
        draws = [builder.draws(draws, max_size, aux0) for _ in sizes]
    slots = torch.arange(max_size, device=dev)
    out = [builder.build(d, max_size, aux0, slots < int(sz)) for d, sz in zip(draws, sizes)]
    return tuple(torch.stack(x) for x in zip(*out))
