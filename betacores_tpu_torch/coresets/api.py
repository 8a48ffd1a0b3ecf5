"""The eager object API (counterpart of betacores_tpu/coresets/api.py).

The reference's user-facing surface: ``build(itrs, sz)``, ``build_trace``,
``optimize()``, ``get()``, ``size()``, ``reset()``, ``error()`` over a
functional core (``CoresetState`` and the builders of
coresets/incremental.py), so a driver reads

    import betacores_tpu_torch as bc
    prj = bc.BetaBlackBoxProjector(sampler, 100, model=logreg.bundle())
    alg = bc.BetaCoreset(Z, prj, beta=0.1, n_subsample_select=1000, ...)
    trace = alg.build_trace(M)

Every constructor takes ``device`` (None: the card; without CUDA that
raises, so a CPU caller passes ``device="cpu"``) and ``graph`` (passed to
the builder: None replays the refinement passes as CUDA graphs on a card).
Randomness is a per-instance ``KeySequence`` of ``torch.Generator``s seeded
at construction; ``error()`` draws from a second one, seeded
``seed ^ 0x5EED0``, once per build, so the before/after comparison inside
``optimize()`` shares one projection.

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item that brings them: ``groups=`` (Queue A item 9), ``ContextualProjector``
(item 7b), ``refine()`` (item 8), ``HilbertCoreset`` (item 8) and
``BatchPSVICoreset`` (item 9).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.base import ModelFns, beta_gradient_from_autodiff
from ..ops.projection import draw_subsample
from ..utils import errors
from ..utils.errors import NumericalPrecisionError
from ..utils.logging import get_logger
from ..utils.prng import KeySequence
from . import state as state_lib
from .incremental import IncrementalConfig, make_incremental_builder


def _round_capacity(sz: int) -> int:
    return max(64, int(np.ceil(sz / 64.0)) * 64)


def _steps_to_i0(step_sched, opt_itrs: int) -> np.ndarray:
    """A reference-style ``step_sched(i)`` callable evaluated into the
    learning-rate array, in float64 on the host (cast once by the caller)."""
    return np.asarray([float(step_sched(i)) for i in range(opt_itrs)], dtype=np.float64)


def resolve_device(device) -> torch.device:
    """``device``, or the card when None. Without CUDA the card raises: an
    entry point never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A item {item})")


class BlackBoxProjector:
    """(sampler, projection_dimension, model): the reference's
    BlackBoxProjector. ``model=`` passes a whole ``ModelFns`` bundle (the
    library models, with their kernels); otherwise one is made from the
    loose ``loglikelihood`` (and ``grad_loglikelihood``). ``theta_dim`` is
    the parameter dimension when it is not the rows' (e.g. the multiclass
    family's K*d, the unknown-covariance Gaussian's d + d*d, Poisson
    regression's D - 1)."""

    def __init__(self, sampler, projection_dimension: int, loglikelihood=None,
                 grad_loglikelihood=None, theta_dim: Optional[int] = None, model=None):
        self.sampler = sampler
        self.projection_dimension = projection_dimension
        self.theta_dim = theta_dim
        if model is not None:
            self.model = model
        else:
            if loglikelihood is None:
                raise ValueError("pass loglikelihood or model=")
            self.model = ModelFns(log_likelihood=loglikelihood,
                                  grad_z_log_likelihood=grad_loglikelihood)


class BetaBlackBoxProjector:
    """The beta-divergence projector bundle; ``model=`` as in
    :class:`BlackBoxProjector`, else one made from ``beta_likelihood`` and
    ``loglikelihood`` (with ``beta_gradient``, or its forward-mode
    derivative)."""

    def __init__(self, sampler, projection_dimension: int, beta_likelihood=None,
                 loglikelihood=None, beta_gradient=None, theta_dim: Optional[int] = None,
                 model=None):
        self.sampler = sampler
        self.projection_dimension = projection_dimension
        self.theta_dim = theta_dim
        if model is not None:
            if model.beta_likelihood is None:
                raise ValueError("model= bundle must carry beta_likelihood")
            self.model = model
        else:
            if beta_likelihood is None or loglikelihood is None:
                raise ValueError("pass (beta_likelihood, loglikelihood) or model=")
            if beta_gradient is None:
                beta_gradient = beta_gradient_from_autodiff(beta_likelihood)
            self.model = ModelFns(log_likelihood=loglikelihood,
                                  beta_likelihood=beta_likelihood,
                                  beta_gradient=beta_gradient)


class ContextualProjector:
    """A projector whose model and sampler depend on a trainable context
    (the neural-linear encoder). Not ported yet."""

    contextual = True

    def __init__(self, *args, **kwargs):
        raise _not_ported("ContextualProjector (contextual builds)", "7b")


def _as_data(data, device: torch.device) -> torch.Tensor:
    """(N, D) floating tensor on ``device``; garbage raises ValueError."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bool or data.is_complex():
            raise ValueError(f"coreset data must be real numbers, got dtype {data.dtype}")
        t = data
    else:
        try:
            a = np.asarray(data)
        except (TypeError, ValueError) as e:
            raise ValueError(f"coreset data must be a numeric array: {e}") from None
        if a.dtype.kind not in "fiu":
            raise ValueError(f"coreset data must be numeric, got dtype {a.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(a))
    if t.ndim != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"coreset data must be (N, D) with N, D >= 1, got {tuple(t.shape)}")
    if not t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    return t.to(device)


class Coreset:
    """Base eager coreset (the reference's Coreset ABC)."""

    # relative error increase beyond which a failed optimize() latches
    # reached_numeric_limit; below it the state is still reverted but
    # further growth is allowed (error() is a Monte-Carlo estimate, so a
    # converged coreset re-optimized under fresh noise may rise by O(noise))
    LATCH_REL_INCREASE = 0.05

    def __init__(self, data, *, seed: int = 0, max_size: int = 0, wts=None, idcs=None,
                 pts=None, beta: float = 0.5, device=None):
        self.device = resolve_device(device)
        self.data = _as_data(data, self.device)
        self.log = get_logger(self.__class__.__name__)
        self.keys = KeySequence(seed, self.device)
        self.reached_numeric_limit = False
        self._beta0 = float(beta)
        cap = _round_capacity(max_size or 1)
        dt = self.data.dtype
        np_dt = torch.empty(0, dtype=dt).numpy().dtype
        if wts is not None:
            cap = max(cap, _round_capacity(len(np.asarray(wts))))
            self.state = state_lib.warm_start_state(
                cap, np.asarray(wts, dtype=np_dt), idcs, np.asarray(pts, dtype=np_dt),
                beta=beta, sampler_aux=self._init_aux(), device=self.device)
            self.initialized = int(self.state.m)
        else:
            self.state = self._empty_state(cap, beta)
            self.initialized = 0

    def _init_aux(self) -> torch.Tensor:
        td = getattr(getattr(self, "projector", None), "theta_dim", None)
        return torch.zeros(td or self.data.shape[1], dtype=self.data.dtype,
                           device=self.device)

    def _empty_state(self, cap: int, beta: float, sampler_aux=None):
        return state_lib.init_state(cap, self.data.shape[1], beta=beta,
                                    sampler_aux=(self._init_aux() if sampler_aux is None
                                                 else sampler_aux),
                                    dtype=self.data.dtype, device=self.device)

    # --- reference API ---
    def reset(self) -> None:
        self.state = self._empty_state(self.state.wts.shape[0], self._beta0)
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((self.state.wts > 0).sum())

    def get(self):
        return state_lib.get(self.state)

    def error(self) -> float:
        return 0.0

    def build(self, itrs: int, sz: int) -> None:
        if self.reached_numeric_limit:
            return
        if sz < self.size():
            raise ValueError(f"{self.__class__.__name__}.build(): cannot shrink coreset "
                             f"(requested {sz} < current {self.size()})")
        self._ensure_capacity(sz)
        self._build(itrs, sz)

    def optimize(self) -> None:
        """Re-run the weight refinement; revert when the error rises by more
        than ``errors.TOL`` relative, and latch ``reached_numeric_limit``
        when it rises by more than ``LATCH_REL_INCREASE``."""
        prev_cost = self.error()
        prev_state = self.state
        try:
            self._optimize()
            new_cost = self.error()
            if new_cost > prev_cost * (1.0 + errors.TOL):
                self.log.warning("optimize() increased error (%g -> %g); reverting",
                                 prev_cost, new_cost)
                self.state = prev_state
                if new_cost > prev_cost * (1.0 + self.LATCH_REL_INCREASE):
                    raise NumericalPrecisionError("optimize() materially increased error")
        except NumericalPrecisionError as e:
            self.log.warning("%s", e)
            self.state = prev_state
            self.reached_numeric_limit = True

    # --- hooks ---
    def _ensure_capacity(self, sz: int) -> None:
        st = self.state
        cap = st.wts.shape[0]
        if sz > cap:
            new = self._empty_state(_round_capacity(sz), self._beta0, st.sampler_aux)
            wts, idcs, pts = new.wts.clone(), new.idcs.clone(), new.pts.clone()
            wts[:cap], idcs[:cap], pts[:cap] = st.wts, st.idcs, st.pts
            self.state = new._replace(wts=wts, idcs=idcs, pts=pts, m=st.m.clone(),
                                      beta=st.beta.clone())

    def _build(self, itrs: int, sz: int) -> None:
        raise NotImplementedError

    def _optimize(self) -> None:
        raise NotImplementedError


class _IncrementalCoreset(Coreset):
    """Shared eager wrapper of SparseVI and beta-Cores over
    coresets/incremental.py's builder."""

    _use_beta = False
    _learn_beta = False

    def __init__(self, data, ll_projector, n_subsample_select=None, n_subsample_opt=None,
                 opt_itrs: int = 100, step_sched: Callable = lambda i: 1.0 / (1.0 + i),
                 beta: float = 0.5, learn_beta: Optional[bool] = None,
                 beta_cap: float = 1.0, seed: int = 0, max_size: int = 0, groups=None,
                 data_weights=None, refit_every: int = 1,
                 dedup_select: bool = False, device=None, graph: Optional[bool] = None,
                 **kw):
        if groups is not None:
            raise _not_ported("groups=", "9")
        if getattr(ll_projector, "contextual", False):
            raise _not_ported("a contextual projector", "7b")
        self.projector = ll_projector  # before super(): _init_aux reads theta_dim
        super().__init__(data, seed=seed, max_size=max_size, beta=beta, device=device, **kw)
        if learn_beta is not None:
            self._learn_beta = learn_beta
        # float64 on the host, cast once to the data's dtype
        step_sizes = torch.from_numpy(_steps_to_i0(step_sched, opt_itrs)).to(
            dtype=self.data.dtype, device=self.device)
        self._cfg = IncrementalConfig(
            projection_dim=ll_projector.projection_dimension,
            n_subsample_select=n_subsample_select, n_subsample_opt=n_subsample_opt,
            opt_itrs=opt_itrs, use_beta=self._use_beta, learn_beta=self._learn_beta,
            beta_cap=beta_cap, refit_every=refit_every, dedup_select=dedup_select)
        u = None if data_weights is None else torch.as_tensor(data_weights)
        self._builder = make_incremental_builder(self.data, ll_projector.model,
                                                 ll_projector.sampler, self._cfg,
                                                 step_sizes=step_sizes, data_weights=u,
                                                 graph=graph)
        # the error draws come from their own stream, so drawing them never
        # shifts the build's; they are drawn once per build
        self._error_keys = KeySequence(seed ^ 0x5EED0, self.device)
        self._error_seed = self._draw_error()

    @property
    def selected_groups(self):
        return []

    def _draws(self, itrs: int):
        """The draws provider of one ``build``/``build_trace`` of ``itrs``
        iterations: the builder's generator draws from the next generator of
        this instance's key sequence."""
        return self._builder.generator_draws(self.keys())

    def _draw_error(self) -> int:
        """The seed of the generator ``error()`` draws its projection from
        until the next build: every call remakes that generator, so it
        draws the same S posterior samples and, under subsampled
        refinement, the same subsample."""
        return self._error_keys().initial_seed()

    def _build(self, itrs: int, sz: int) -> None:
        if self.size() + itrs > sz:
            raise ValueError(f"{self.__class__.__name__}._build(): itrs + current size "
                             f"({self.size()} + {itrs}) exceeds desired size {sz}")
        self.state = self._builder.build(self.state, int(itrs), self._draws(int(itrs)))
        self._error_seed = self._draw_error()

    def error(self) -> float:
        """The tangent-space residual norm of the current coreset under the
        projection drawn at the last build (the reference's incremental
        coresets return 0 here, which leaves ``optimize()``'s rollback
        guard vacuous)."""
        gen = torch.Generator(device=self.device).manual_seed(self._error_seed)
        return float(self._builder.error(self.state, gen))

    def _optimize(self) -> None:
        self.state = self._builder.optimize(self.state,
                                            self._builder.generator_draws(self.keys()))

    def refine(self, n_samples: int = 500, n_subsample=None) -> None:
        raise _not_ported("refine() (it needs snnls/nnls.py)", "8")

    def build_trace(self, itrs: int):
        """``itrs`` incremental iterations, returning each iteration's
        compact coreset ``[(wts, pts, idcs, beta)] * itrs`` (what a
        ``for m: build(1, m); get()`` loop gives, from the same draws).
        Advances this coreset to the final size. Warm-start slots with
        indices outside the data report their own coordinates."""
        self._ensure_capacity(int(self.state.m) + itrs)
        pts0 = self.state.pts.cpu().numpy()      # after growth: the warm slots
        st, (W, I, B) = self._builder.build_trace(self.state, int(itrs),
                                                  self._draws(int(itrs)))
        self.state = st
        self._error_seed = self._draw_error()
        N = self.data.shape[0]
        I_dev = I.to(torch.int64)
        P = self.data[I_dev.clamp(0, N - 1)].cpu().numpy()   # (itrs, cap, D)
        W, I, B = W.cpu().numpy(), I.cpu().numpy(), B.cpu().numpy()
        ext = (I < 0) | (I >= N)
        if ext.any():
            slot = np.broadcast_to(np.arange(I.shape[1]), I.shape)
            P[ext] = pts0[slot[ext]]
        out = []
        for m in range(itrs):
            keep = W[m] > 0
            out.append((W[m][keep], P[m][keep], I[m][keep], float(B[m])))
        return out


class SparseVICoreset(_IncrementalCoreset):
    """Sparse variational-inference coreset (Campbell & Beronov 2019)."""

    _use_beta = False
    _learn_beta = False


class BetaCoreset(_IncrementalCoreset):
    """beta-Cores: a robust coreset under the beta-divergence (Manousakas &
    Mascolo, WSDM 2021), with ``learn_beta``. ``get()`` returns beta too."""

    _use_beta = True

    def __init__(self, data, ll_projector, beta: float = 0.5, learn_beta: bool = False,
                 **kw):
        super().__init__(data, ll_projector, beta=beta, learn_beta=learn_beta, **kw)

    def get(self):
        w, p, i = super().get()
        return w, p, i, float(self.state.beta)


class HilbertCoreset(Coreset):
    """Hilbert coreset by sparse NNLS. Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("HilbertCoreset (it needs snnls/)", "8")


class BatchPSVICoreset(Coreset):
    """Batch pseudo-coreset. Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("BatchPSVICoreset", "9")


def uniform_coreset_draws(generator: torch.Generator, n: int, N: int) -> np.ndarray:
    """The next ``n`` draws of a uniform-sampling stream: iid indices in
    [0, N) from a host ``generator``, so n draws at once equal n draws one
    at a time."""
    return torch.randint(0, N, (n,), generator=generator).numpy()


def weighted_coreset_draws(generator: torch.Generator, n: int, p=None,
                           cdf=None) -> np.ndarray:
    """The next ``n`` iid categorical draws by inverse CDF over ``cdf`` (a
    normalised, non-decreasing float64 CDF) or, when it is not given,
    probabilities ``p`` (the CDF then formed in float64 on the host).
    Zero-mass entries are never drawn only when the caller compacts them
    out of the support first."""
    if cdf is None:
        if p is None:
            raise ValueError("pass p or cdf")
        cum = np.cumsum(np.asarray(p, dtype=np.float64))
        cdf = cum / cum[-1]
    cdf = torch.as_tensor(np.asarray(cdf, dtype=np.float64))
    u = torch.rand((n,), generator=generator, dtype=torch.float64)
    return torch.clamp(torch.searchsorted(cdf, u, right=True), 0, cdf.shape[0] - 1).numpy()


class UniformSamplingCoreset(Coreset):
    """The uniform-sampling baseline: iid draws with multiplicity counts,
    w = N * cts / sum(cts) (or, with ``data_weights`` u, importance draws
    ~ u / sum(u) with weights scaled by sum(u); rows of zero weight are
    never drawn). A constructor warm start is a persistent count-1 prefix
    whose points may lie outside the data.

    The draws come from a host ``torch.Generator`` seeded with ``seed`` and
    a counter of draws made, so ``build_trace`` and a ``build(1, m)`` loop
    give the same stream, and ``reset`` rewinds it. Selection is host
    bookkeeping; the device state is made lazily when it is read."""

    def __init__(self, data, seed: int = 0, groups=None, data_weights=None, device=None,
                 **kw):
        if groups is not None:
            raise _not_ported("groups=", "9")
        self._dirty = False
        super().__init__(data, seed=seed, device=device, **kw)
        self._seed = seed
        if data_weights is not None:
            uw = np.asarray(data_weights.cpu() if isinstance(data_weights, torch.Tensor)
                            else data_weights, dtype=np.float64)
            if uw.shape != (self.data.shape[0],):
                raise ValueError(f"data_weights must be ({self.data.shape[0]},), "
                                 f"got {uw.shape}")
            if not uw.sum() > 0:
                raise ValueError("data_weights: total mass must be positive")
            self._u_total = float(uw.sum())
            self._u_pos = np.flatnonzero(uw > 0)
            # the CDF over the positive support, once, in float64
            cdf = np.cumsum(uw[self._u_pos])
            self._u_cdf = cdf / cdf[-1]
        else:
            self._u_total = self._u_pos = self._u_cdf = None
        self.cts: dict[int, int] = {}
        if kw.get("wts") is not None and kw.get("idcs") is not None:
            self._warm = (np.asarray(kw["idcs"], dtype=np.int64).copy(),
                          np.atleast_2d(np.asarray(kw["pts"])).copy())
        else:
            self._warm = None
        self._rewind()

    def _rewind(self) -> None:
        self._gen = torch.Generator().manual_seed(self._seed)
        self._n_drawn = 0

    @property
    def state(self):
        if self._dirty:
            self._dirty = False
            self._sync_device_state()
        return self._state

    @state.setter
    def state(self, value):
        self._state = value

    def reset(self) -> None:
        self.cts = {}
        self._dirty = False
        self._warm = None
        self._rewind()
        super().reset()

    def size(self) -> int:
        n_warm = 0 if self._warm is None else len(self._warm[0])
        if self.cts or self._dirty:
            return len(self.cts) + n_warm
        return super().size()

    def _ensure_capacity(self, sz: int) -> None:
        # reads only the buffer's shape: must not trigger the lazy sync
        if sz > self._state.wts.shape[0]:
            was_dirty, self._dirty = self._dirty, False
            super()._ensure_capacity(sz)
            self._dirty = was_dirty

    def _draw_points(self, itrs: int) -> np.ndarray:
        """The next ``itrs`` drawn row indices of this instance's stream."""
        self._n_drawn += itrs
        if self._u_cdf is None:
            return uniform_coreset_draws(self._gen, itrs, self.data.shape[0])
        return self._u_pos[weighted_coreset_draws(self._gen, itrs, cdf=self._u_cdf)]

    def _total(self) -> float:
        return float(self.data.shape[0]) if self._u_total is None else self._u_total

    def _build(self, itrs: int, sz: int) -> None:
        if self.size() + itrs > sz:
            raise ValueError("UniformSamplingCoreset._build(): size overrun")
        for f in self._draw_points(itrs):
            self.cts[int(f)] = self.cts.get(int(f), 0) + 1
        if self.cts:
            self._dirty = True

    def build_trace(self, itrs: int):
        """Each iteration's compact coreset ``[(wts, pts, idcs)] * itrs``,
        as a ``for m: build(1, m); get()`` loop reports it (same stream),
        with one gather of the points at the end. The warm prefix appears in
        every snapshot with its own coordinates."""
        N, total = self.data.shape[0], self._total()
        widcs = np.zeros(0, dtype=np.int64) if self._warm is None else self._warm[0]
        n_warm = len(widcs)
        snaps = []
        for f in self._draw_points(itrs):
            self.cts[int(f)] = self.cts.get(int(f), 0) + 1
            idcs = np.fromiter(self.cts.keys(), dtype=np.int64)
            cts = np.concatenate([np.ones(n_warm), np.fromiter(self.cts.values(),
                                                               dtype=np.float64)])
            snaps.append((np.concatenate([widcs, idcs]), total * cts / cts.sum()))
        self._dirty = True
        all_idcs = np.fromiter(self.cts.keys(), dtype=np.int64)
        row_of = {int(i): r for r, i in enumerate(all_idcs)}
        P = self.data[torch.from_numpy(np.clip(all_idcs, 0, N - 1)).to(self.device)]
        P = P.cpu().numpy()
        wP = (np.zeros((0, self.data.shape[1]), dtype=P.dtype) if n_warm == 0
              else np.atleast_2d(self._warm[1]).astype(P.dtype))
        return [(wts.astype(P.dtype),
                 np.concatenate([wP, P[[row_of[int(i)] for i in idcs[n_warm:]]]]), idcs)
                for idcs, wts in snaps]

    def _sync_device_state(self) -> None:
        N = self.data.shape[0]
        idcs = np.fromiter(self.cts.keys(), dtype=np.int64)
        cts = np.fromiter(self.cts.values(), dtype=np.float64)
        self._ensure_capacity(len(idcs) + (0 if self._warm is None else len(self._warm[0])))
        pts = self.data[torch.from_numpy(np.clip(idcs, 0, N - 1)).to(self.device)]
        pts = pts.cpu().numpy()
        if self._warm is not None:
            widcs, wpts = self._warm
            idcs = np.concatenate([widcs, idcs])
            pts = np.concatenate([np.atleast_2d(wpts).astype(pts.dtype), pts], axis=0)
            cts = np.concatenate([np.ones(len(widcs)), cts])
        wts = self._total() * cts / cts.sum()
        self.state = state_lib.warm_start_state(
            self._state.wts.shape[0], wts.astype(pts.dtype), idcs, pts, beta=self._beta0,
            sampler_aux=self._init_aux(), device=self.device)

    def _optimize(self) -> None:
        pass
