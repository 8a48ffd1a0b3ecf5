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
            card, its plain version on the CPU) when the sampler is a
            Laplace family; any other model or sampler, or a weighted
            build, takes the composed route through utils/opt.py::nn_adam.
            Full-data refinement (``n_subsample_opt=None``) projects every
            row at each step.

``learn_beta`` refines beta with the weights: one projected Adam over
x = [w, beta], beta clamped to [1e-3, ``beta_cap``], the beta-gradient from
the model's ``beta_gradient`` (each family's closed form; reference
incremental.py:507-535, which takes a forward-mode derivative). It always
takes the composed route (or the full-data one), never K1, and refits the
posterior every step, as the reference's learn_beta branch does.

``data_weights`` (N,) makes row n count u_n times in the residual target
scaling * sum_n u_n v_n; zero-weight rows are never selected.

Projections of at least FUSED_MIN_ROWS rows go to the model's fused
projection (ops/projection.py), e.g. the multiclass kernel K2 in
full-candidate select.

Random draws are separated from compute: ``build`` takes a draws provider
(``GeneratorDraws`` draws from a ``torch.Generator``; ``FixedDraws``
replays given tensors, e.g. the JAX package's own draws).

A sampler without a noise split (``draw_noise``/``from_noise``), such as
the NIW sampler of models/mvn.py, whose gamma shapes change with the
weights at every step, cannot have a pass's noise drawn ahead. It takes the
per-step-draw route, the reference's path for such a sampler (its
``nn_adam`` with per-step keys): select and every refinement step call
``sampler(generator, S, w, pts, aux)`` and then draw the step's subsample,
from the generator of a ``GeneratorDraws`` (``FixedDraws`` raises). The
subsampled pass draws from a generator the pass keeps, into which the
draws' generator state is copied before the pass and from which it is
copied back after, so the stream is the one drawing from the draws'
generator would give; on a CUDA device the pass is captured like the
composed route, with that generator registered with each graph.
``DeviceDraws`` draws from the default generator of the data's device
instead, as an exported build does (utils/export.py).

Where the reference's build is one jitted program, a subsampled refinement
pass here is a device-resident program too: the builder keeps static
buffers for everything a pass reads or carries (``FusedPass`` of
ops/kernels.py for the fused route, ``_ComposedPass`` below), each
selection copies its state and draws into them, and the step body, which
reads and writes only those buffers and no device value on the host, is
captured as a CUDA graph and replayed (utils/graphs.py). ``graph`` says
whether: ``None`` (the default) captures on a CUDA device and runs the same
body eagerly on the CPU, ``False`` always runs it eagerly, ``True`` off a
CUDA device raises. A capture that fails raises. Select, the draws and
this builder's full-data refinement (one (N, S) projection per step) stay
eager; the group builder (coresets/groups.py) runs its full-data pass
through ``_ComposedPass`` and so captures it too.

``optimize`` is the program's ``refine`` span (utils/profiling.py), the
parent of the refits' ``newton`` spans: free while the recorder is off, a
record while a profiler runs or under ``profiling.recording()``.

A contextual builder (``contextual=True``: the model and sampler are
factories ``ctx -> ModelFns`` and ``ctx -> sampler``, e.g. over the
neural-linear encoder of models/neural_linear.py) resolves the factories
once, at make time, on its ``ContextBuffers``: static tensors on the data's
device that the resolved functions read at every call. Each entry point
takes ``ctx`` (a mapping of names to tensors) and copies it into those
buffers first, so a pass captured under one context replays under the
next; no context is ever captured as a constant.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Protocol, Sequence, Tuple

import torch

from ..ops.kernels import FusedPass, adam_sclr_stack, maybe_fused
from ..ops.projection import (draw_subsample, project_beta, project_beta_with_grad,
                              project_ll)
from ..utils import profiling
from ..utils.graphs import PassRunner, capture_stats, resolve_graph, signature
from ..utils.opt import adam_bias_corrections, adam_update, nn_adam, step_schedule
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
    learn_beta: bool = False           # refine beta jointly with the weights
    # True: mask already-selected rows out of the candidate argmax and always
    # install the best remaining candidate. False: reference parity (a
    # duplicate argmax, or an existing point out-scoring every candidate,
    # adds nothing).
    dedup_select: bool = False
    # refit the posterior only every k-th refinement step, reusing the last
    # fit for the steps between
    refit_every: int = 1
    beta_grad_scale: float = 1e-5      # damping of the learn_beta gradient
    beta_cap: float = 1.0              # learn_beta clamps beta to [1e-3, beta_cap]

    def __post_init__(self):
        if self.learn_beta and not self.use_beta:
            raise ValueError("learn_beta requires use_beta=True")
        if self.refit_every < 1:
            raise ValueError("refit_every must be >= 1")


BETA_FLOOR = 1e-3                      # learn_beta's lower clamp (the 1/beta pole)
# a composed pass on pre-drawn rows appends the coreset buffer to each of
# its T steps' rows while those copies take at most this many bytes
JOINT_MAX_BYTES = 256 * 1024 * 1024


def laplace_family(sampler) -> bool:
    """Whether ``sampler`` splits its fit from its draws (``fit``,
    ``from_fit``, ``fit_aux``), as the fused step and lagged refits need."""
    return all(getattr(sampler, n, None) is not None
               for n in ("fit", "from_fit", "fit_aux"))


def noise_split(sampler) -> bool:
    """Whether ``sampler`` splits its draws from its transform
    (``draw_noise``, ``from_noise``); a sampler without the split takes the
    per-step-draw route."""
    return all(getattr(sampler, n, None) is not None for n in ("draw_noise", "from_noise"))


def require_lagged_fit(sampler, config: IncrementalConfig) -> None:
    """Raises unless ``sampler`` serves the lagged refits a subsampled
    ``refit_every > 1`` build asks for (``fit``, ``from_fit``,
    ``fit_aux``): the reference ignores ``refit_every`` for a sampler
    without them, the port refuses it."""
    if config.n_subsample_opt is None or config.refit_every == 1 or config.learn_beta:
        return
    for name in ("fit", "from_fit", "fit_aux"):
        if getattr(sampler, name, None) is None:
            raise NotImplementedError(f"refit_every > 1 needs a sampler with fit, "
                                      f"from_fit and fit_aux; this one lacks {name}")


class ContextBuffers(Mapping):
    """A contextual builder's context: one static tensor per name on the
    builder's device. ``load(ctx)`` copies a context in: the first load
    makes the buffers (in the context's dtypes), every later one copies
    into them and must bring the same names and shapes. Reading a name
    before the first load raises."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: Optional[dict] = None

    def load(self, ctx: Mapping) -> None:
        if self._bufs is None:
            self._bufs = {k: torch.as_tensor(v).detach().to(self.device).clone()
                          for k, v in ctx.items()}
            return
        if set(ctx) != set(self._bufs):
            raise ValueError(f"ctx names {sorted(ctx)} != the builder's {sorted(self._bufs)}")
        for k, v in ctx.items():
            v = torch.as_tensor(v)
            if v.shape != self._bufs[k].shape:
                raise ValueError(f"ctx[{k!r}] has shape {tuple(v.shape)}, the builder's "
                                 f"{tuple(self._bufs[k].shape)}")
            self._bufs[k].copy_(v)

    def __getitem__(self, k):
        if self._bufs is None:
            raise ValueError("a contextual build needs its ctx (e.g. alg.ctx = nl.variables)")
        return self._bufs[k]

    def __iter__(self):
        return iter(self._bufs or {})

    def __len__(self) -> int:
        return len(self._bufs or {})


class DeviceDraws:
    """The per-step-draw route's draws from the default generator of the
    data's device (``generator`` None), which the caller seeds with
    ``torch.manual_seed``: those an exported per-step-draw build makes
    (utils/export.py), since a program can take no ``torch.Generator``."""

    generator = None


def _generator_of(draws) -> Optional[torch.Generator]:
    if isinstance(draws, DeviceDraws):
        return None
    gen = getattr(draws, "generator", None)
    if gen is None:
        raise ValueError("a sampler without a noise split draws inside each step: pass "
                         "draws with a generator (GeneratorDraws), not replayed tensors")
    return gen


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
    # the range select draws its candidates from (None: the rows; the
    # group builder's candidates are groups)
    n_candidates: Optional[int] = None

    def select(self, it, st):
        z = self.sampler.draw_noise(self.generator, self.n_samples, st.wts,
                                    st.pts, st.sampler_aux)
        if self.n_sel is None:
            return z, None
        n = self.n_total if self.n_candidates is None else self.n_candidates
        idx, _ = draw_subsample(self.generator, n, self.n_sel)
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


def _store(buffers, values) -> None:
    """Copies a tensor, or a tuple of tensors and Nones, into buffers of
    the same structure."""
    if isinstance(values, torch.Tensor):
        buffers.copy_(values)
        return
    for b, v in zip(buffers, values):
        if v is not None:
            b.copy_(v)


def _buffers_like(values):
    if isinstance(values, torch.Tensor):
        return torch.empty_like(values)
    return type(values)(*(None if v is None else torch.empty_like(v) for v in values))


class _ComposedPass:
    """The static buffers and the step body of a composed-route refinement
    pass: the pass's pre-drawn noise, rows and row weights, a copy of the
    state the projections read, the Adam carry ``x``, ``m1``, ``m2``, the
    sampler's carry (the warm start, or with lagged refits the whole fit)
    and the step counter ``i`` on the device. The body is
    utils/opt.py::nn_adam's step on those buffers. Under ``learn_beta`` the
    carry is x = [w, beta], M_buf + 1 long; a builder's configuration is
    fixed, so its passes are all of one kind, and a learn_beta pass never
    shares buffers or graphs with a weights-only pass of the same size.

    On the per-step-draw route (``z_all`` None: a sampler without a noise
    split) there is no pre-drawn noise or rows: each step calls the
    sampler on the pass's own generator ``gen`` and then draws its
    subsample from it.

    Under full-data refinement (``n_opt`` None, the group builder's
    exact-gradient pass, coresets/groups.py) a step draws no subsample: it
    projects every row of the builder's data and takes the target
    ``u @ vecs`` with the builder's target weights ``u``."""

    def __init__(self, builder: "IncrementalBuilder", st: CoresetState, z_all, runner):
        cfg, smp = builder.config, builder.sampler
        dt, dev = builder.data.dtype, builder.data.device
        T = builder.step_sizes.shape[0] if z_all is None else z_all.shape[0]
        n_opt = builder.n_opt
        M_buf, D = st.pts.shape
        self.builder, self.runner, self.n_steps = builder, runner, T
        self.learn_beta = cfg.learn_beta
        self.full = n_opt is None
        # the reference's learn_beta branch refits every step
        self.lagged = cfg.refit_every > 1 and not self.learn_beta
        # ... and projects the subsample and the buffer separately. On
        # pre-drawn rows the buffer is appended to every step's rows once,
        # before the pass, only while those T copies fit JOINT_MAX_BYTES; a
        # larger buffer (a group build's, up to every row) projects on its
        # own at each step
        self.joint = builder._joint_pass(T, st.pts, pre_drawn=z_all is not None)
        self.gen = None
        self.rows_all = self.z_all = self.u_all = None
        if z_all is None:
            self.gen = torch.Generator(device=dev)
            runner.generators = (self.gen,)
        else:
            self.z_all = torch.empty_like(z_all)
        if z_all is not None and not self.full:
            self.rows_all = torch.empty((T, n_opt + (M_buf if self.joint else 0), D),
                                        dtype=dt, device=dev)
            self.u_all = (None if builder.u is None
                          else torch.empty((T, n_opt), dtype=dt, device=dev))
        self.st = CoresetState(*(torch.empty_like(t) for t in st))
        n_x = M_buf + (1 if self.learn_beta else 0)
        self.x, self.m1, self.m2 = (torch.zeros(n_x, dtype=st.wts.dtype, device=dev)
                                    for _ in range(3))
        # per-step [lr, 1-b1^t, 1-b2^t] in the weights' dtype, as nn_adam forms them
        self.sclr = torch.cat([builder.step_sizes.to(st.wts.dtype)[:, None],
                               adam_bias_corrections(T, st.wts.dtype, dev)], dim=1)
        self.i = torch.zeros(1, dtype=torch.int64, device=dev)
        if self.lagged:
            # one fit, to learn the carry's structure
            self.carry = _buffers_like(smp.fit(st.wts, st.pts, st.sampler_aux))
        else:
            fit_dtype = torch.promote_types(torch.promote_types(st.wts.dtype, st.pts.dtype),
                                            st.sampler_aux.dtype)
            self.carry = torch.empty_like(st.sampler_aux, dtype=fit_dtype)
        self.weighted = builder.u is not None
        # a per-step-draw or full-data step reads the data itself, so a
        # captured one reads these tensors (``build_with_data`` swaps them)
        self.reads = (builder.data, builder.u) if z_all is None or self.full else None
        self.like = signature((*st, *(() if z_all is None else (z_all,))))

    def serves(self, st, z_all) -> bool:
        """Whether these buffers fit this state, these draws and the
        builder's data and data weights (``build_with_data`` may bring or
        drop them)."""
        b = self.builder
        return (self.like == signature((*st, *(() if z_all is None else (z_all,))))
                and self.weighted == (b.u is not None)
                and (self.reads is None or (self.reads[0] is b.data and self.reads[1] is b.u)))

    def fill(self, st: CoresetState, z_all, idx_all, generator=None) -> None:
        """Copies the state and the pass's draws in: pre-drawn noise and
        rows, or on the per-step-draw route the state of ``generator``."""
        b, n_opt = self.builder, self.builder.n_opt
        _store(self.st, st)
        if self.gen is not None:
            self.gen.set_state(generator.get_state())
        else:
            self.z_all.copy_(z_all)
        if self.rows_all is not None:
            self.rows_all[:, :n_opt] = b.data[idx_all]
            if self.joint:
                # the buffer is constant over the pass: appended to every
                # step's rows once, outside the loop
                self.rows_all[:, n_opt:] = st.pts
            if self.u_all is not None:
                self.u_all.copy_(b.u[idx_all])
        M_buf = st.wts.shape[0]
        self.x[:M_buf].copy_(st.wts)
        if self.learn_beta:
            self.x[M_buf:].copy_(st.beta.reshape(1))
        self.m1.zero_()
        self.m2.zero_()
        self.i.zero_()
        if not self.lagged:
            self.carry.copy_(st.sampler_aux)

    def _first_fit(self) -> None:
        sst = self.st
        _store(self.carry, self.builder.sampler.fit(sst.wts, sst.pts, sst.sampler_aux))

    def _drawn_step(self, w):
        """(samples, rows, usub) of a per-step-draw step: the sampler's
        draw, then the subsample, from the pass's generator."""
        b, sst = self.builder, self.st
        samples, aux = b.sampler(self.gen, b.config.projection_dim, w, sst.pts, self.carry)
        self.carry.copy_(aux)
        if self.full:
            return samples, b.data, b.u
        idx, _ = draw_subsample(self.gen, b.data.shape[0], b.n_opt)
        rows = b.data.index_select(0, idx)
        if self.joint:
            rows = torch.cat([rows, sst.pts])
        return samples, rows, None if b.u is None else b.u.index_select(0, idx)

    def _step(self, refit: bool) -> None:
        b, sst = self.builder, self.st
        w = self.x[:sst.wts.shape[0]]
        if self.gen is not None:
            samples, rows, usub = self._drawn_step(w)
        else:
            samples, rows, usub = self._pre_drawn_step(w, refit)
        scaling = 1.0 if self.full else b.data.shape[0] / b.n_opt
        g = b._composed_grad(self.x, sst, samples, rows, usub, scaling, self.joint)
        sclr = self.sclr.index_select(0, self.i)[0]
        x, m1, m2 = adam_update(self.x, self.m1, self.m2, g, sclr[0], sclr[1], sclr[2])
        self.x.copy_(x)
        self.m1.copy_(m1)
        self.m2.copy_(m2)
        self.i.add_(1)

    def _pre_drawn_step(self, w, refit: bool):
        """(samples, rows, usub) of a step on pre-drawn noise and rows."""
        b, smp = self.builder, self.builder.sampler
        z = self.z_all.index_select(0, self.i)[0]
        if self.full:
            rows, usub = b.data, b.u
        else:
            rows = self.rows_all.index_select(0, self.i)[0]
            usub = None if self.u_all is None else self.u_all.index_select(0, self.i)[0]
        if self.lagged:
            if refit:
                _store(self.carry, smp.fit(w, self.st.pts, smp.fit_aux(self.carry)))
            samples = smp.from_fit(self.carry, z)
        else:
            samples, aux = smp.from_noise(z, w, self.st.pts, self.carry)
            self.carry.copy_(aux)
        return samples, rows, usub

    def run(self) -> None:
        k = self.builder.config.refit_every
        if self.lagged:
            self.runner.run("first fit", self._first_fit)
        self.runner.run_pass(self.n_steps, self._step,
                             lambda i: not self.lagged or (i % k == 0 and i > 0))

    def result(self, st: CoresetState) -> CoresetState:
        """``st`` with the pass's weights (and beta) and warm start, as
        tensors of their own (the buffers are reused)."""
        aux = self.builder.sampler.fit_aux(self.carry) if self.lagged else self.carry
        M_buf = st.wts.shape[0]
        if self.learn_beta:
            st = st._replace(beta=self.builder._clamp_beta(self.x[M_buf]))
        return st._replace(wts=self.x[:M_buf].clone(), sampler_aux=aux.clone())


class IncrementalBuilder:
    """``build(state, itrs, draws)`` runs itrs x (select + optimize);
    ``build_trace`` also returns each iteration's (wts, idcs, beta);
    ``select`` / ``optimize`` run one half-iteration;
    ``build_with_data`` runs ``build`` over other data of the same shape;
    ``error(state, draws)`` is the tangent-space residual norm
    (``make_tangent_error``). Each but ``select`` takes ``ctx``, which a
    contextual builder (``ctx`` its ``ContextBuffers``) copies in first
    (``load_ctx``); None keeps the last one. ``graph``: see the module docstring and
    utils/graphs.py."""

    def __init__(self, data, model, sampler, config: IncrementalConfig,
                 step_sizes: torch.Tensor, data_weights: Optional[torch.Tensor] = None,
                 graph: Optional[bool] = None, ctx: Optional[ContextBuffers] = None):
        self.ctx = ctx
        self.data = data
        self.model = model
        self.sampler = sampler
        self.config = config
        self.step_sizes = step_sizes
        self.u = data_weights
        self.graph = resolve_graph(graph, data.device)
        self.per_step = not noise_split(sampler)
        N = data.shape[0]
        self.n_sel = (None if config.n_subsample_select is None
                      else min(N, config.n_subsample_select))
        self.n_opt = (None if config.n_subsample_opt is None
                      else min(N, config.n_subsample_opt))
        self._model_fstep = (None if config.learn_beta or not laplace_family(sampler)
                             else getattr(model, "fused_beta_grad_step" if config.use_beta
                                          else "fused_ll_grad_step", None))
        # (T, 3) per-step Adam scalars of the fused step, fixed per build
        self.sclr_all = (None if self._model_fstep is None or self.n_opt is None
                         else adam_sclr_stack(step_sizes))
        # the passes' static buffers and graphs, made at the first pass
        self._fused: Optional[FusedPass] = None
        self._composed: Optional[_ComposedPass] = None
        self._bias_corrections: dict = {}
        self._error = make_tangent_error(data, model, sampler, config, data_weights)

    def load_ctx(self, ctx: Optional[Mapping]) -> None:
        """Copies ``ctx`` into the context buffers (None: keep the last)."""
        if ctx is None:
            return
        if self.ctx is None:
            raise ValueError("ctx given to a builder made without contextual=True")
        self.ctx.load(ctx)

    def error(self, st: CoresetState, draws, ctx: Optional[Mapping] = None) -> torch.Tensor:
        """The tangent-space residual norm (``make_tangent_error``)."""
        self.load_ctx(ctx)
        return self._error(st, draws)

    @property
    def fstep(self):
        """The model's fused step when it serves the build (a subsampled,
        unweighted refinement without learn_beta, with a Laplace-family
        sampler), else None."""
        return None if self.n_opt is None or self.u is not None else self._model_fstep

    def _runner(self) -> PassRunner:
        return PassRunner(self.graph)

    def capture_stats(self) -> tuple:
        """(CUDA graphs captured so far, host seconds spent capturing)."""
        return capture_stats((self._fused, self._composed))

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

    def _joint_pass(self, n_steps: int, pts, pre_drawn: bool) -> bool:
        """Whether a composed pass of ``n_steps`` steps projects each step's
        rows and the buffer ``pts`` as one block: never under learn_beta or
        full-data refinement, only where the routing is the same
        (``_joint_rows_identical``), and on pre-drawn rows only while the
        buffer's ``n_steps`` copies take at most JOINT_MAX_BYTES."""
        M_buf, D = pts.shape
        return (not self.config.learn_beta and self.n_opt is not None
                and self._joint_rows_identical(self.n_opt + M_buf)
                and (not pre_drawn or n_steps * M_buf * D * pts.element_size()
                     <= JOINT_MAX_BYTES))

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

    def _clamp_beta(self, b):
        return torch.clamp(b, BETA_FLOOR, self.config.beta_cap)

    def _joint_grad(self, x, samples, rows, usub, scaling, st: CoresetState):
        """The learn_beta gradient over x = [w, beta] (reference
        incremental.py:524-531): the weights' -(corevecs @ resid) / S and
        beta's -beta_grad_scale * w . (betagrads @ resid) / S, at beta
        clamped to [1e-3, beta_cap]. The rows and the buffer project
        separately, the buffer with its beta-gradient."""
        cfg, S = self.config, self.config.projection_dim
        w, beta = x[:-1], self._clamp_beta(x[-1])
        mask = st.slot_mask[:, None].to(self.data.dtype)
        vecs = project_beta(self.model, rows, samples, beta)
        corevecs, betagrads = project_beta_with_grad(self.model, st.pts, samples, beta)
        corevecs, betagrads = corevecs * mask, betagrads * mask
        resid = scaling * _target_sum(vecs, usub) - w @ corevecs
        betagrad = -cfg.beta_grad_scale * (w @ (betagrads @ resid)) / S
        return torch.cat([-(corevecs @ resid) / S, betagrad.reshape(1)])

    def _composed_grad(self, x, st: CoresetState, samples, rows, usub, scaling: float,
                       joint: bool):
        """The composed route's gradient at x (the weights, or [w, beta]
        under learn_beta) on one step's samples and rows."""
        if self.config.learn_beta:
            return self._joint_grad(x, samples, rows, usub, scaling, st)
        vecs, corevecs = self._tangent(rows, st, samples, joint)
        resid = scaling * _target_sum(vecs, usub) - x[:st.wts.shape[0]] @ corevecs
        return -(corevecs @ resid) / self.config.projection_dim

    def select(self, st: CoresetState, draws: Draws, it: int = 0) -> CoresetState:
        """Reference bcores.py:74-90 / sparsevi.py:74-96."""
        data, S, n_sel = self.data, self.config.projection_dim, self.n_sel
        if self.per_step:
            gen = _generator_of(draws)
            samples, aux = self.sampler(gen, S, st.wts, st.pts, st.sampler_aux)
            sub_idcs = (None if n_sel is None
                        else draw_subsample(gen, data.shape[0], n_sel, data.device)[0])
        else:
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

    @profiling.spanned("refine")
    def optimize(self, st: CoresetState, draws: Draws, it: int = 0,
                 ctx: Optional[Mapping] = None) -> CoresetState:
        """Reference bcores.py:126-150 on pre-drawn noise and subsample rows:
        through the model's fused step when it serves the build, else
        composed; full-data refinement projects every row per step."""
        self.load_ctx(ctx)
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
        learn_beta, M_buf = self.config.learn_beta, st.wts.shape[0]
        if self.per_step:
            gen, xs = _generator_of(draws), None
        else:
            xs = (draws.optimize(it, st)[0],)

        def grad_fn(x, aux, i, xs_i=None):
            if xs_i is None:
                samples, aux = smp(gen, S, x[:M_buf], st.pts, aux)
            else:
                samples, aux = smp.from_noise(xs_i[0], x[:M_buf], st.pts, aux)
            if learn_beta:
                return self._joint_grad(x, samples, self.data, self.u, 1.0, st), aux
            vecs, corevecs = self._tangent(self.data, st, samples, joint=False)
            resid = _target_sum(vecs, self.u) - x @ corevecs
            return -(corevecs @ resid) / S, aux

        key = (st.wts.dtype, st.wts.device)
        if key not in self._bias_corrections:       # formed on the host: once per builder
            self._bias_corrections[key] = adam_bias_corrections(self.step_sizes.shape[0], *key)
        x0 = torch.cat([st.wts, st.beta.reshape(1)]) if learn_beta else st.wts
        x, aux = nn_adam(x0, grad_fn, st.sampler_aux, self.step_sizes, xs=xs,
                         bias_corrections=self._bias_corrections[key])
        if learn_beta:
            st = st._replace(beta=self._clamp_beta(x[M_buf]))
        return st._replace(wts=x[:M_buf], sampler_aux=aux)

    def _optimize_composed(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """The composed route (reference incremental.py:430-496): per step
        the sampler turns the step's noise into samples (refitting the
        posterior, or every k-th step with ``refit_every``), the subsample
        and the buffer are projected, and the projected-Adam update takes
        the gradient -(corevecs @ resid) / S (``_ComposedPass``). On the
        per-step-draw route the pass draws from a copy of the draws'
        generator, whose state is copied back after."""
        gen = z_all = idx_all = None
        if self.per_step:
            gen = _generator_of(draws)
        else:
            z_all, idx_all = draws.optimize(it, st)
        p = self._composed
        if p is None or not p.serves(st, z_all):
            p = self._composed = _ComposedPass(self, st, z_all, self._runner())
        p.fill(st, z_all, idx_all, gen)
        p.run()
        if gen is not None:
            gen.set_state(p.gen.get_state())
        return p.result(st)

    def _optimize_fused(self, st: CoresetState, draws: Draws, it: int) -> CoresetState:
        """The fused-step route: the pass's noise and subsample rows are
        packed into the static buffers once, then each step is one Newton
        refit (every k-th step with ``refit_every``) plus one fused step."""
        data, S, n_opt = self.data, self.config.projection_dim, self.n_opt
        z_all, idx_all = draws.optimize(it, st)
        p = self._fused
        if p is None or not p.serves(st, z_all):
            # full(), not tensor(): a host-to-device copy would synchronise
            scaling = torch.full((1,), data.shape[0] / n_opt, dtype=torch.float32,
                                 device=data.device)
            p = self._fused = FusedPass(self.sampler, st, z_all, n_opt, S, self.sclr_all,
                                        scaling, self.config.refit_every, data.dtype,
                                        self._runner())
        p.fill(data[idx_all], st, z_all)
        fstep = self.fstep

        def step(refit: bool) -> None:
            if refit:
                p.refit()
            xin, z, sclr = p.step_operands()
            p.advance(*fstep(xin, z, p.mu, p.linv, p.w, p.m1, p.m2, p.sc, sclr, S))

        p.run(step)
        return p.result(st)

    def build(self, st: CoresetState, itrs: int, draws: Draws,
              ctx: Optional[Mapping] = None) -> CoresetState:
        self.load_ctx(ctx)
        for it in range(itrs):
            st = self.optimize(self.select(st, draws, it), draws, it)
        return st

    def build_trace(self, st: CoresetState, itrs: int, draws: Draws,
                    ctx: Optional[Mapping] = None):
        """(state, (wts, idcs, beta)) with each stacked over iterations."""
        self.load_ctx(ctx)
        trace = []
        for it in range(itrs):
            st = self.optimize(self.select(st, draws, it), draws, it)
            trace.append((st.wts, st.idcs, st.beta))
        return st, tuple(torch.stack(x) for x in zip(*trace))

    def build_with_data(self, data, data_weights, st: CoresetState, itrs: int,
                        draws: Draws, ctx: Optional[Mapping] = None) -> CoresetState:
        """``build`` over caller-supplied ``data`` (and ``data_weights``, or
        None) of the make-time shape: the same buffers and captured
        programs serve every same-shape dataset (the reference runs its
        one compiled program per chunk this way). N and D are baked into
        the subsample ranges, the scaling and the buffers, so another
        shape raises."""
        N = self.data.shape[0]
        if tuple(data.shape) != tuple(self.data.shape):
            raise ValueError(f"build_with_data: data shape {tuple(data.shape)} != the "
                             f"builder's {tuple(self.data.shape)} (N and D are baked into "
                             f"the subsample ranges and scaling)")
        if data_weights is not None and tuple(data_weights.shape) != (N,):
            raise ValueError(f"build_with_data: weights must be ({N},), got "
                             f"{tuple(data_weights.shape)}")
        mine = (self.data, self.u)
        self.data = data.to(dtype=mine[0].dtype, device=mine[0].device)
        self.u = (None if data_weights is None
                  else data_weights.to(dtype=mine[0].dtype, device=mine[0].device))
        try:
            return self.build(st, itrs, draws, ctx)
        finally:
            self.data, self.u = mine


def make_tangent_error(data: torch.Tensor, model, sampler, config: IncrementalConfig,
                       data_weights: Optional[torch.Tensor] = None):
    """``error(st, draws)``: the tangent-space residual norm
    ||scaling * sum_n u_n v_n - w . corevecs|| / S under one posterior draw
    (u_n = 1 without ``data_weights``), over the refinement's subsample or,
    with ``n_subsample_opt=None``, over every row (reference
    incremental.py:606-654). ``draws`` is a ``torch.Generator`` on the
    data's device, from which the sampler draws its S samples and then the
    subsample is drawn, or a pair (z (S, d), idx (n_opt,) or None) to
    replay through a sampler with a noise split. The same
    draws on two states compare them under the same samples and rows."""
    N, S = data.shape[0], config.projection_dim
    n_opt = None if config.n_subsample_opt is None else min(N, config.n_subsample_opt)
    u = None if data_weights is None else data_weights.to(dtype=data.dtype, device=data.device)

    def error(st: CoresetState, draws) -> torch.Tensor:
        if isinstance(draws, torch.Generator):
            samples, _ = sampler(draws, S, st.wts, st.pts, st.sampler_aux)
            idx = None if n_opt is None else draw_subsample(draws, N, n_opt)[0]
        else:
            z, idx = draws
            samples, _ = sampler.from_noise(z.to(data.device), st.wts, st.pts, st.sampler_aux)
            idx = None if idx is None else idx.to(data.device)
        if (idx is None) != (n_opt is None):
            raise ValueError("error: the draws carry a subsample exactly when the "
                             "refinement is subsampled")
        if config.use_beta:
            proj = lambda pts: project_beta(model, pts, samples, st.beta)
        else:
            proj = lambda pts: project_ll(model, pts, samples)
        if idx is None:
            scaling, tsum = 1.0, _target_sum(proj(data), u)
        else:
            scaling = N / n_opt
            tsum = _target_sum(proj(data[idx]), None if u is None else u[idx])
        corevecs = proj(st.pts) * st.slot_mask[:, None].to(data.dtype)
        resid = scaling * tsum - st.wts @ corevecs
        return torch.sqrt(torch.sum(resid * resid)) / S

    return error


def make_incremental_builder(
    data: torch.Tensor,
    model,
    sampler,
    config: IncrementalConfig,
    step_sizes: Optional[torch.Tensor] = None,
    data_weights: Optional[torch.Tensor] = None,
    graph: Optional[bool] = None,
    contextual: bool = False,
) -> IncrementalBuilder:
    """The builder over ``data`` (N, D): select over every row or a
    subsample, refinement on a subsample or every row, optional (N,)
    base-data weights ``data_weights``. ``graph``: whether the subsampled
    refinement passes run as replayed CUDA graphs (None: on a CUDA device;
    True elsewhere raises). A subsampled, unweighted refinement takes the
    model's fused step when it has one when the sampler is a Laplace family
    (``fit``, ``from_fit``, ``fit_aux``; ``fit_inv`` when present), else the
    composed route (which needs ``fit``, ``from_fit`` and ``fit_aux`` for
    lagged refits). A sampler with a noise split (the Laplace, conjugate,
    fixed and prior samplers) has its noise drawn per pass; one without
    (the NIW sampler) takes the per-step-draw route (module docstring).
    ``learn_beta`` refines beta too, through the composed or full-data
    route; it needs a model with ``beta_gradient``. A sampler the route
    cannot use raises NotImplementedError rather than taking another
    route. ``contextual``: ``model`` and ``sampler`` are factories of a
    context (module docstring), resolved here on the builder's
    ``ContextBuffers``."""
    ctx = None
    if contextual:
        ctx = ContextBuffers(data.device)
        model, sampler = model(ctx), sampler(ctx)
    if config.learn_beta and getattr(model, "beta_gradient", None) is None:
        raise ValueError("learn_beta requires a model with beta_gradient")
    N = data.shape[0]
    if data_weights is not None:
        if tuple(data_weights.shape) != (N,):
            raise ValueError(f"data_weights must be ({N},), got "
                             f"{tuple(data_weights.shape)}")
        data_weights = data_weights.to(dtype=data.dtype, device=data.device)
    # full-data refinement and learn_beta refit every step; lagged refits
    # need a Laplace-family sampler; a sampler without a noise split takes
    # the per-step-draw route
    if not noise_split(sampler) and not callable(sampler):
        raise NotImplementedError("the sampler has neither a noise split (draw_noise, "
                                  "from_noise) nor a call sampler(generator, n, wts, pts, "
                                  "aux)")
    require_lagged_fit(sampler, config)
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return IncrementalBuilder(data, model, sampler, config, step_sizes, data_weights,
                              graph, ctx)
