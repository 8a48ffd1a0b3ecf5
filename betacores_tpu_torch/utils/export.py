"""Deployment artifacts: a build as a loadable program (counterpart of
betacores_tpu/utils/export.py).

Serving wants the traced program as a versioned artifact: ship the bytes,
load them in a worker that never imports the model code, and call, with no
retracing and no Python closure over the model. ``export_program`` traces a
function with ``torch.export.export`` and returns ``torch.export.save``'s
bytes; ``load_program`` reads them back into a callable, moved onto a
``device`` (``torch.export.passes.move_to_device_pass``, the counterpart of
the reference's ``platforms=``: one artifact serves the CPU and the card).
Loading imports the state namedtuples and registers the port's two
kernel ops (``betacores_torch::logreg_adam_step``, K1, and
``betacores_torch::multiclass_projection``, K2, ops/kernels.py), and
nothing of a model or a builder.

``export_incremental_build`` exports one whole build of an incremental
builder (coresets/incremental.py) over a traced ``itrs``: an outer
``while_loop`` over selections, and within each the select pass, the
refinement as an inner ``while_loop`` over its T steps (K1's op for each
step on the fused route) and the Newton refits, which are fixed-count
loops already (inference/laplace.py). Shapes are static: the artifact
serves the traced shapes. Which builders export:

- a builder whose sampler has a noise split (the Laplace, conjugate, fixed
  and prior samplers), on every select and refinement route, weighted or
  not, with ``learn_beta`` too. A program cannot take a
  ``torch.Generator``, so where the reference takes a key the artifact
  takes its draws as an operand: ``BuildDraws``, the select and refinement
  draws of ``capacity`` selections stacked, made by ``stack_draws`` in the
  order ``GeneratorDraws`` draws them, so that ``FixedDraws`` of the same
  stack (``fixed_draws``) replays the live build. Signature ``(data,
  [data_weights,] draws, state, itrs) -> state``, every ``itrs`` up to the
  stack's selections. ``learn_beta`` needs the model's beta-gradient in
  closed form (every family's bundle has it; the forward-mode derivative
  of ``models.base.beta_gradient_from_autodiff`` is not traced inside a
  loop body, and raises NotImplementedError);
- a per-step-draw builder (a sampler without a noise split, such as the
  NIW sampler, whose gamma shapes follow the weights): the program draws
  inside itself, from the default generator of its device, in the live
  route's order. Signature ``(data, [data_weights,] state, itrs) ->
  state``, seeded by the caller with ``torch.manual_seed`` (or
  ``torch.cuda.manual_seed``), where the reference's artifact takes a key.

A contextual builder raises NotImplementedError: the program would bake its
context in as constants. The group and sharded builders are not exported,
as the reference exports only the single-device point builder.
"""

from __future__ import annotations

import io
import os
import warnings
from typing import Callable, NamedTuple, Optional

import torch

_REGISTERED = False


class BuildDraws(NamedTuple):
    """A build's draws for ``capacity`` selections, stacked: select's noise
    (M, S, d) and candidate rows (M, n_sel), the refinement's noise
    (M, T, S, d) and rows (M, T, n_opt). A row leaf is None where the
    builder scores or projects every row."""

    z_sel: torch.Tensor
    idx_sel: Optional[torch.Tensor]
    z_opt: torch.Tensor
    idx_opt: Optional[torch.Tensor]


def _register() -> None:
    """Registers the state namedtuples for serialisation under their
    names, and the kernel ops, once."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.utils._pytree import SUPPORTED_SERIALIZED_TYPES, _register_namedtuple

    from ..coresets.state import CoresetState, GroupCoresetState
    from ..inference.laplace import LaplaceApprox
    from ..ops import kernels  # noqa: F401  (defines the betacores_torch ops)

    for cls in (CoresetState, GroupCoresetState, LaplaceApprox, BuildDraws):
        if cls not in SUPPORTED_SERIALIZED_TYPES:
            _register_namedtuple(cls, serialized_type_name=f"betacores_tpu_torch.{cls.__name__}")
    _REGISTERED = True


class _Program(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn: Callable, *example_args) -> bytes:
    """Trace ``fn`` on ``example_args`` (tensors and namedtuples of
    tensors; only their shapes, dtypes and devices are read) and return the
    serialized program."""
    _register()
    # static shapes: the loop bodies are traced by dynamo, which must not
    # turn the operands' sizes into symbols
    with torch._dynamo.config.patch(assume_static_by_default=True,
                                    automatic_dynamic_shapes=False), warnings.catch_warnings():
        # the cached constants (an identity, the Newton grid) are traced
        # through their cache, as they should be: a traced op each
        warnings.filterwarnings("ignore", message=".*functools.lru_cache")
        ep = torch.export.export(_Program(fn), tuple(example_args), strict=True)
    # the artifact is the program: the example operands (a whole dataset and
    # its draws) stay out of it
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_program(data: bytes, device=None) -> Callable:
    """The program of :func:`export_program` as a callable. ``device``
    moves its constants and device arguments there (None: where it was
    traced); its operands must be on that device."""
    _register()
    ep = torch.export.load(io.BytesIO(data))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    return ep.module()


def save_program(path: str, fn: Callable, *example_args) -> str:
    """``export_program`` to a file; returns ``path``."""
    data = export_program(fn, *example_args)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)  # atomic: a serving worker never reads a torn file
    return path


def load_program_file(path: str, device=None) -> Callable:
    with open(path, "rb") as fh:
        return load_program(fh.read(), device)


# ---------------------------------------------------------------------------
# The incremental build as one program
# ---------------------------------------------------------------------------

def stack_draws(builder, generator: torch.Generator, state, selections: int) -> BuildDraws:
    """``selections`` selections' draws from ``generator``, in the order
    ``builder.generator_draws(generator)`` draws them (select, then the
    refinement, selection by selection), stacked."""
    gd = builder.generator_draws(generator)
    sel, opt = [], []
    for it in range(selections):
        sel.append(gd.select(it, state))
        opt.append(gd.optimize(it, state))
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    return BuildDraws(stack([z for z, _ in sel]), stack([i for _, i in sel]),
                      stack([z for z, _ in opt]), stack([i for _, i in opt]))


def fixed_draws(draws: BuildDraws):
    """The ``FixedDraws`` that replays ``draws`` through the live builder."""
    from ..coresets.incremental import FixedDraws

    M = draws.z_sel.shape[0]
    at = lambda t, i: None if t is None else t[i]
    return FixedDraws([(draws.z_sel[i], at(draws.idx_sel, i)) for i in range(M)],
                      [(draws.z_opt[i], at(draws.idx_opt, i)) for i in range(M)])


def _pick(t, i):
    """t[i] for a 0-d index tensor i, as a traced program can index."""
    return None if t is None else torch.index_select(t, 0, i.reshape(1))[0]


class _ProgramDraws:
    """The draws of selection ``it`` (a 0-d tensor) from the stack."""

    def __init__(self, draws: BuildDraws):
        self.draws = draws

    def select(self, it, st):
        return _pick(self.draws.z_sel, it), _pick(self.draws.idx_sel, it)

    def optimize(self, it, st):
        return _pick(self.draws.z_opt, it), _pick(self.draws.idx_opt, it)


def _while(cond, body, carried):
    """``while_loop`` whose body may return one of its operands as it is
    (a pass-through warm start): such an output is copied, as the loop
    requires."""
    from torch._higher_order_ops import while_loop

    def fresh_body(*ins):
        outs = body(*ins)
        return tuple(o.clone() if any(o is i for i in ins) else o for o in outs)

    return while_loop(cond, fresh_body, tuple(carried))


def _fused_pass(b, N: int, st, z_all, idx_all):
    """The fused route (ops/kernels.py::FusedPass) as a program: the pass's
    rows and noise packed once, then T steps of the Newton refit (every
    k-th with ``refit_every``) and K1's op."""
    from ..ops.kernels import make_refit_state, pack_fused_step_rows, pad_fused_step_noise

    f32 = torch.float32
    S, n_opt, k = b.config.projection_dim, b.n_opt, b.config.refit_every
    M_buf = st.wts.shape[0]
    xin_all, M_pad, _ = pack_fused_step_rows(b.data[idx_all], st.pts, st.slot_mask, n_opt)
    z_pad = pad_fused_step_noise(z_all, S)
    sc = torch.cat([st.beta.reshape(1).to(f32),
                    torch.full((1,), N / n_opt, dtype=f32, device=st.pts.device)])
    refit_state = make_refit_state(b.sampler, st.pts)
    fit_aux, fstep, w_dtype, sclr_all = b.sampler.fit_aux, b.fstep, b.data.dtype, b.sclr_all
    dev, d = st.pts.device, z_all.shape[-1]
    fit_dtype = torch.promote_types(torch.promote_types(st.wts.dtype, st.pts.dtype),
                                    st.sampler_aux.dtype)
    w0 = torch.zeros((1, M_pad), dtype=f32, device=dev)
    w0[0, :M_buf] = st.wts
    aux = st.sampler_aux.to(fit_dtype)
    mu, linv = torch.zeros((1, d), dtype=f32, device=dev), torch.zeros((d, d), dtype=f32,
                                                                        device=dev)

    def refit(w, aux):
        lap, linv = refit_state(w, aux)
        # the warm start and the mode are one tensor: copied, a loop carries
        # no two outputs that alias
        return fit_aux(lap).to(fit_dtype, copy=True), lap.mu.to(f32).reshape(1, d), linv

    if k > 1:
        aux, mu, linv = refit(st.wts, aux)

    def cond(i, w, m1, m2, aux, mu, linv):
        return i < z_all.shape[0]

    def body(i, w, m1, m2, aux, mu, linv):
        new = refit(w[0, :M_buf].to(w_dtype), aux)
        if k > 1:
            now = (i % k == 0) & (i > 0)
            new = tuple(torch.where(now, n, o) for n, o in zip(new, (aux, mu, linv)))
        aux, mu, linv = new
        w, m1, m2 = fstep(_pick(xin_all, i), _pick(z_pad, i), mu, linv, w, m1, m2, sc,
                          _pick(sclr_all, i), S)
        return i + 1, w, m1, m2, aux, mu, linv

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    _, w, _, _, aux, _, _ = _while(cond, body, (zero, w0, torch.zeros_like(w0),
                                                torch.zeros_like(w0), aux, mu, linv))
    return st._replace(wts=w[0, :M_buf].to(st.wts.dtype), sampler_aux=aux)


def _composed_pass(b, N: int, sclr_all, st, z_all, idx_all):
    """The composed and full-data routes (``_ComposedPass``,
    ``_optimize_full``) as a program: per step the sampler's draw (a refit,
    or every k-th step with ``refit_every``), the gradient and the
    projected-Adam update; under ``learn_beta`` over x = [w, beta], beta
    clamped inside the gradient and at the end. On the per-step-draw route
    (``z_all`` None) each step calls the sampler and then draws its
    subsample, from the default generator of the device."""
    from ..ops.projection import draw_subsample
    from ..utils.opt import adam_update

    cfg, smp, S = b.config, b.sampler, b.config.projection_dim
    T, M_buf = sclr_all.shape[0], st.wts.shape[0]
    full, learn_beta, per_step = b.n_opt is None, cfg.learn_beta, z_all is None
    lagged = cfg.refit_every > 1 and not learn_beta and not full and not per_step
    k = cfg.refit_every
    dt, dev = st.wts.dtype, st.wts.device
    joint, rows_all, u_all, fit0 = False, None, None, None
    if full:
        scaling = 1.0
    else:
        scaling = N / b.n_opt
        joint = b._joint_pass(T, st.pts, pre_drawn=not per_step)
    if not full and not per_step:
        rows_all = b.data[idx_all]
        u_all = None if b.u is None else b.u[idx_all]
        if joint:
            rows_all = torch.cat([rows_all, st.pts.expand(T, *st.pts.shape)], dim=1)
    x0 = torch.cat([st.wts, st.beta.reshape(1)]) if learn_beta else st.wts.clone()
    if lagged:
        # the whole fit is the carry: its tensors, its None fields dropped
        fit0 = smp.fit(st.wts, st.pts, st.sampler_aux)
        carry0 = tuple(t for t in fit0 if t is not None)
    else:
        fit_dtype = torch.promote_types(torch.promote_types(dt, st.pts.dtype),
                                        st.sampler_aux.dtype)
        carry0 = (st.sampler_aux.to(fit_dtype),)

    def as_fit(carry):
        it = iter(carry)
        return type(fit0)(*(None if t is None else next(it) for t in fit0))

    def cond(i, x, m1, m2, *carry):
        return i < T

    def body(i, x, m1, m2, *carry):
        w = x[:M_buf]
        if per_step:
            samples, aux = smp(None, S, w, st.pts, carry[0])
            carry = (aux,)
        elif lagged:
            z = _pick(z_all, i)
            fit = smp.fit(w, st.pts, smp.fit_aux(as_fit(carry)))
            new = tuple(t for t in fit if t is not None)
            now = (i % k == 0) & (i > 0)
            carry = tuple(torch.where(now, n, o) for n, o in zip(new, carry))
            samples = smp.from_fit(as_fit(carry), z)
        else:
            samples, aux = smp.from_noise(_pick(z_all, i), w, st.pts, carry[0])
            carry = (aux,)
        if full:
            rows, usub = b.data, b.u
        elif per_step:
            idx, _ = draw_subsample(None, N, b.n_opt, dev)
            rows = b.data.index_select(0, idx)
            if joint:
                rows = torch.cat([rows, st.pts])
            usub = None if b.u is None else b.u.index_select(0, idx)
        else:
            rows, usub = _pick(rows_all, i), _pick(u_all, i)
        g = b._composed_grad(x, st, samples, rows, usub, scaling, joint)
        sclr = _pick(sclr_all, i)
        x, m1, m2 = adam_update(x, m1, m2, g, sclr[0], sclr[1], sclr[2])
        return (i + 1, x, m1, m2, *carry)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out = _while(cond, body, (zero, x0, torch.zeros_like(x0), torch.zeros_like(x0), *carry0))
    x, carry = out[1], out[4:]
    aux = smp.fit_aux(as_fit(carry)) if lagged else carry[0]
    if learn_beta:
        st = st._replace(beta=b._clamp_beta(x[M_buf]))
    return st._replace(wts=x[:M_buf], sampler_aux=aux)


def build_program(builder, weighted: Optional[bool] = None):
    """fn(data, [data_weights,] draws, state, itrs) -> state: ``itrs``
    selections of ``builder`` over the operands, as ``export_program``
    traces it (``weighted``: take data weights; default whether the builder
    has its own). A per-step-draw builder (a sampler without a noise split,
    such as the NIW sampler) gives fn(data, [data_weights,] state, itrs) ->
    state, which draws from the default generator of its device (see
    ``export_incremental_build``). Raises NotImplementedError for a builder
    the program cannot express: a contextual builder, or a ``learn_beta``
    builder whose model's beta-gradient is the forward-mode derivative."""
    from ..coresets.incremental import DeviceDraws
    from ..coresets.state import CoresetState
    from ..utils.opt import adam_bias_corrections

    if builder.config.learn_beta and getattr(builder.model.beta_gradient, "forward_mode",
                                             False):
        raise NotImplementedError(
            "export: learn_beta needs the model's beta_gradient in closed form, as every "
            "family's bundle gives it (e.g. models/logreg.py::beta_gradient); this model's "
            "is the forward-mode derivative (beta_gradient_from_autodiff), which "
            "torch.export does not trace inside the refinement loop")
    if builder.ctx is not None:
        raise NotImplementedError(
            "export: a contextual builder reads its context from buffers the program "
            "would bake in as constants (ROADMAP Queue A item 13, export)")

    # the sizes as Python numbers, fixed before tracing (a size read off a
    # traced operand is a symbol, which a loop cannot carry as a float)
    N = builder.data.shape[0]
    # the composed route's per-step [lr, 1-b1^t, 1-b2^t] in the weights'
    # dtype, as _ComposedPass forms them, made here: a constant made inside a
    # loop body cannot be serialized
    sclr_all = None
    if builder.fstep is None:
        dt, dev = builder.data.dtype, builder.data.device
        sclr_all = torch.cat([builder.step_sizes.to(dt)[:, None],
                              adam_bias_corrections(builder.step_sizes.shape[0], dt, dev)],
                             dim=1)

    def program(data, u, draws: Optional[BuildDraws], state, itrs):
        mine = (builder.data, builder.u)
        builder.data, builder.u = data, u
        try:
            if draws is None:
                src = DeviceDraws()
            else:
                src = _ProgramDraws(draws)
                n_max = draws.z_sel.shape[0]
                torch._assert_async(itrs <= n_max, "itrs exceeds the selections of the draws")

            def cond(it, *st):
                return it < itrs

            def body(it, *st):
                st = builder.select(CoresetState(*st), src, it)
                z_all = idx_all = None
                if draws is not None:
                    z_all, idx_all = src.optimize(it, st)
                if builder.fstep is not None:
                    st = _fused_pass(builder, N, st, z_all, idx_all)
                else:
                    st = _composed_pass(builder, N, sclr_all, st, z_all, idx_all)
                return (it + 1, *st)

            it0 = torch.zeros((), dtype=itrs.dtype, device=itrs.device)
            out = _while(cond, body, (it0, *state))
            return CoresetState(*out[1:])
        finally:
            builder.data, builder.u = mine

    weighted = builder.u is not None if weighted is None else weighted
    if builder.per_step:
        if weighted:
            return lambda data, u, state, itrs: program(data, u, None, state, itrs)
        return lambda data, state, itrs: program(data, None, None, state, itrs)
    if weighted:
        return program
    return lambda data, draws, state, itrs: program(data, None, draws, state, itrs)


def export_incremental_build(builder, data_spec, state, data_weights_spec=None,
                             draws_spec: Optional[BuildDraws] = None) -> bytes:
    """Serialize ``builder``'s whole build (a ``make_incremental_builder``
    result) as a program.

    ``data_spec`` is a tensor of the dataset operand's shape (the dataset is
    an ARGUMENT: the artifact serves any dataset of that shape), ``state``
    a ``CoresetState`` template (``init_state``), ``draws_spec`` a
    ``BuildDraws`` of the selections the artifact serves (default: one
    selection per slot of the state, drawn from a generator seeded 0). The
    signature is ``(data, draws, state, itrs) -> state``, or
    ``(data, data_weights, draws, state, itrs) -> state`` when the builder
    was made with ``data_weights`` (the spec defaults to the builder's own
    weights, so the artifact never drops them) or ``data_weights_spec`` is
    given, with ``itrs`` a 0-d int64 operand: one artifact serves every
    build size up to the draws' selections. ``learn_beta`` builds export
    (the beta-gradient is each family's closed form); under ``learn_beta``
    a model whose beta-gradient is the forward-mode derivative
    (``models.base.beta_gradient_from_autodiff``, e.g. the object API's
    for a bare ``beta_likelihood``) raises NotImplementedError, and so does
    a contextual builder (``build_program``).

    A per-step-draw builder (a sampler without a noise split, such as the
    NIW sampler, whose gamma shapes follow the weights) draws inside the
    program instead: the sampler's draws, the select subsample and each
    step's subsample, in the live route's order, from the default generator
    of the device the artifact runs on. Its signature is
    ``(data, state, itrs) -> state`` or ``(data, data_weights, state,
    itrs) -> state``: no draws operand (``draws_spec`` is not taken) and no
    bound on ``itrs``. The caller seeds it as the JAX artifact's caller
    passes a key: ``torch.manual_seed(s)`` (every device) or
    ``torch.cuda.manual_seed(s)`` before the call, and the same seed gives
    the same state. It cannot replay a live build's draws, which come from
    the builder's own generator.

    An ``itrs`` past the draws' selections is refused by an assert inside
    the program. On the CPU the call raises ``RuntimeError("itrs exceeds
    the selections of the draws")``. On a card the assert runs on the
    device: the call returns, and the next operation that waits for the
    card raises ``RuntimeError: CUDA error: device-side assert
    triggered``; the process's CUDA context is then unusable, so every
    later CUDA call in it fails too (tests/test_torch_kernels_cuda.py runs
    it in a subprocess). A caller that takes ``itrs`` from outside checks
    it against ``draws.z_sel.shape[0]`` on the host first, or runs the
    artifact in a process of its own."""
    if data_weights_spec is None:
        data_weights_spec = builder.u
    weighted = data_weights_spec is not None
    fn = build_program(builder, weighted)
    itrs = torch.zeros((), dtype=torch.int64, device=state.wts.device)
    if builder.per_step:
        drawn = ()
    else:
        if draws_spec is None:
            gen = torch.Generator(device=state.wts.device).manual_seed(0)
            draws_spec = stack_draws(builder, gen, state, state.wts.shape[0])
        drawn = (draws_spec,)
    weights = (data_weights_spec,) if weighted else ()
    return export_program(fn, data_spec, *weights, *drawn, state, itrs)
