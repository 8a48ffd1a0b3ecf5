"""Differentially-private batch pseudo-coreset (DP-BPSVI) (counterpart of
betacores_tpu/coresets/dpbpsvi.py).

BPSVI whose refinement touches the private data only through each step's
sum of projection vectors, released by the Gaussian mechanism:

  1. each row's centred projection vector v_n (an S-vector) is clipped to
     L2 norm <= clip_norm;
  2. noise N(0, (noise_multiplier * clip_norm)^2 I) is added to the sum,
     which is then rescaled (1/q, or N / n_opt).

Everything downstream is post-processing of those releases and of the
synthetic pseudo-points, so a build is (eps, delta)-DP by RDP composition
of its T step releases and ONE noised clipped-mean release that seeds the
pseudo-points (std noise_multiplier * 2 * init_clip_norm / N; the clip and
the scatter around the mean are the public ``DPConfig`` constants).

``DPConfig.sampling``: ``"poisson"`` (each row enters a step's batch
independently with probability q = n_subsample_opt / N; the subsampled
Gaussian accountant under add/remove), or ``"swr"`` (a fixed-size batch
drawn WITHOUT replacement, accounted as T unamplified Gaussian mechanisms
under substitution). The Poisson batch lands in a fixed ``cap``-row buffer
(a cumsum and a scatter, snnls/nnls.py::support_slots, no host read); the
probability that it overflows is charged to delta (``poisson_overflow_p``).

The accountants are plain float arithmetic on the host, copied from the
JAX package. A build's draws (the init noise, each step's posterior noise,
batch and release noise) are made before its pass, from a
``torch.Generator`` or replayed (``DPDraws``); the pass is BPSVI's
``JointPass``, replayed as CUDA graphs on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.projection import center
from ..snnls.nnls import support_slots
from ..utils.device import resolve_device
from ..utils.graphs import PassRunner, resolve_graph
from ..utils.opt import step_schedule
from ..utils.prng import KeySequence
from .api import _as_data, _steps_to_i0
from .bpsvi import BPSVIConfig, JointPass
from .incremental import noise_split


@dataclasses.dataclass(frozen=True)
class DPConfig:
    clip_norm: float = 1.0
    noise_multiplier: float = 1.0
    delta: float = 1e-5
    # public init constants: no statistic of the data but the noised
    # clipped mean reaches the initial pseudo-points
    init_clip_norm: float = 10.0   # per-row L2 clip of the noised-mean release
    init_spread: float = 1.0       # scatter of the pseudo-points around the mean
    sampling: str = "poisson"      # "poisson" or "swr"

    def __post_init__(self):
        if self.sampling not in ("poisson", "swr"):
            raise ValueError(f"sampling must be 'poisson' or 'swr', got {self.sampling!r}")


def _rdp_epsilon_from_ratio2(total_ratio2: float, delta: float) -> float:
    """eps of a composition of Gaussian mechanisms with
    total_ratio2 = sum_i (Delta_i / sigma_i)^2, through RDP:
    RDP_alpha = total_ratio2 * alpha / 2, eps = min_alpha RDP_alpha +
    log(1/delta) / (alpha - 1)."""
    alphas = np.concatenate([np.linspace(1.01, 64.0, 512), np.arange(65, 512)])
    rdp = total_ratio2 * alphas / 2.0
    eps = rdp + math.log(1.0 / delta) / (alphas - 1.0)
    return float(np.min(eps))


def gaussian_rdp_epsilon(steps: int, noise_multiplier: float, delta: float,
                         sens_factor: float = 2.0, init_releases: int = 1) -> float:
    """(eps, delta) of one ``"swr"`` build under SUBSTITUTION of one
    record: ``steps`` releases of the clipped step sum (sensitivity
    ``sens_factor`` clip norms against noise ``noise_multiplier`` clip
    norms) and ``init_releases`` noised-mean init releases
    ((Delta / sigma)^2 = 1 / noise_multiplier^2), composed through RDP."""
    nm2 = noise_multiplier ** 2
    return _rdp_epsilon_from_ratio2((steps * sens_factor ** 2 + init_releases) / nm2, delta)


# integer Renyi orders of the subsampled-Gaussian accountant
_SGM_ORDERS = np.concatenate([np.arange(2, 129), np.arange(136, 513, 8)])


def sgm_rdp(q: float, noise_multiplier: float, orders: np.ndarray = _SGM_ORDERS) -> np.ndarray:
    """RDP curve of ONE sampled-Gaussian-mechanism release (Mironov, Talwar
    & Zhang 2019, arXiv:1908.10530, section 3.3): for integer alpha

        RDP(alpha) = 1/(alpha-1) * logsumexp_k [ log C(alpha,k)
                     + k log q + (alpha-k) log(1-q) + k(k-1)/(2 s^2) ]

    evaluated in log space."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    s2 = float(noise_multiplier) ** 2
    if q == 1.0:
        return np.asarray(orders, dtype=float) / (2.0 * s2)
    if q == 0.0:
        return np.zeros(len(orders))
    from scipy.special import gammaln, logsumexp

    out = np.empty(len(orders))
    logq, log1q = math.log(q), math.log1p(-q)
    for i, a in enumerate(np.asarray(orders, dtype=int)):
        k = np.arange(a + 1)
        log_binom = gammaln(a + 1) - gammaln(k + 1) - gammaln(a - k + 1)
        terms = log_binom + k * logq + (a - k) * log1q + k * (k - 1) / (2.0 * s2)
        out[i] = logsumexp(terms) / (a - 1)
    return out


def poisson_overflow_p(n: int, q: float, cap: int) -> float:
    """Bernstein upper bound on P(Binomial(n, q) > cap): the probability
    that one step's Poisson batch overflows its ``cap``-row buffer."""
    mean, var = n * q, n * q * (1.0 - q)
    t = cap - mean
    if t <= 0:
        return 1.0
    return float(math.exp(-t * t / (2.0 * (var + t / 3.0))))


def poisson_batch_cap(n: int, q: float) -> int:
    """The Poisson batch buffer's rows: mean + 10 sigma + 16, rounded up
    to 8 (overflow probability below 1e-16 per step)."""
    mean = n * q
    sd = math.sqrt(max(n * q * (1.0 - q), 1.0))
    cap = int(math.ceil(mean + 10.0 * sd + 16.0))
    return min(n, ((cap + 7) // 8) * 8)


def subsampled_gaussian_epsilon(steps: int, q: float, noise_multiplier: float, delta: float,
                                init_releases: int = 1, n: Optional[int] = None,
                                cap: Optional[int] = None) -> float:
    """(eps, delta) of one Poisson build under ADD/REMOVE: ``steps``
    sampled-Gaussian releases at rate ``q`` plus ``init_releases`` init
    releases ((Delta / sigma)^2 = 1 / (2 nm)^2). With ``n`` and ``cap`` the
    buffer-overflow probability of every step is charged to delta first."""
    if n is not None and cap is not None:
        delta_trunc = steps * poisson_overflow_p(n, q, cap)
        if delta_trunc >= delta / 2:
            raise ValueError(f"Poisson buffer truncation mass {delta_trunc:.3e} eats the "
                             f"delta budget {delta:.1e}; raise the cap")
        delta = delta - delta_trunc
    orders = np.asarray(_SGM_ORDERS, dtype=float)
    rdp = steps * sgm_rdp(q, noise_multiplier, _SGM_ORDERS)
    rdp = rdp + init_releases * (1.0 / (4.0 * noise_multiplier ** 2)) * orders / 2.0
    eps = rdp + math.log(1.0 / delta) / (orders - 1.0)
    return float(np.min(eps))


class DPDraws(NamedTuple):
    """The draws of one DP-BPSVI build: the init release's noise (D,) and
    the pseudo-points' scatter (sz, D); per step the posterior noise
    (T, S, d), the batch (T, N) bool inclusions under ``"poisson"`` or
    (T, n_opt) rows drawn without replacement under ``"swr"``, and the
    release noise (T, S)."""

    init_noise: torch.Tensor
    init_scatter: torch.Tensor
    z_all: torch.Tensor
    batch_all: torch.Tensor
    noise_all: torch.Tensor


class DPPass(JointPass):
    """The joint pass whose data term is the privatized step sum: the
    batch's centred log-likelihood vectors, each clipped to ``clip_norm``,
    summed, plus ``noise_multiplier * clip_norm`` times the step's release
    noise, rescaled by 1/q (Poisson) or N / n_opt (swr)."""

    def __init__(self, owner, M, z_like, aux, batch_like, runner):
        super().__init__(owner, M, z_like, aux, runner)
        self.batch_all = torch.empty_like(batch_like)
        self.noise_all = torch.empty((self.n_steps, owner.projection_dim),
                                     dtype=owner.data.dtype, device=owner.data.device)

    def target(self, samples):
        o = self.owner
        data, N = o.data, o.data.shape[0]
        batch = self.batch_all.index_select(0, self.i)[0]
        if o.poisson:
            idx, valid = support_slots(batch, o.cap)
            vecs = center(o.model.log_likelihood(data[idx], samples))
            vecs = vecs * valid.to(vecs.dtype)[:, None]
            scaling = 1.0 / o.q
        else:
            vecs = center(o.model.log_likelihood(data[batch], samples))
            scaling = N / o.n_opt
        # --- the only statistic of the data: clipped, summed and noised ---
        norms = torch.linalg.norm(vecs, dim=1, keepdim=True)
        vecs = vecs * torch.clamp_max(o.dp.clip_norm / torch.clamp_min(norms, 1e-12), 1.0)
        noise = self.noise_all.index_select(0, self.i)[0]
        return vecs.sum(dim=0) + o.noise_std * noise, scaling


class DPBPSVIBuilder:
    """``build(draws, sz, aux0) -> (wts, pts)`` (also ``builder(...)``);
    ``draws`` is a ``torch.Generator`` on the data's device or a
    ``DPDraws``. No data index is released."""

    def __init__(self, data, model, sampler, config: BPSVIConfig, dp: DPConfig, step_sizes,
                 graph: Optional[bool]):
        N = data.shape[0]
        self.data, self.model, self.sampler, self.config, self.dp = (data, model, sampler,
                                                                     config, dp)
        self.projection_dim = config.projection_dim
        self.n_opt = min(N, config.n_subsample_opt) if config.n_subsample_opt else N
        self.step_sizes = step_sizes
        self.noise_std = dp.noise_multiplier * dp.clip_norm
        self.poisson = dp.sampling == "poisson"
        self.q = self.n_opt / N
        self.cap = poisson_batch_cap(N, self.q) if self.poisson else None
        self.graph = resolve_graph(graph, data.device)
        self._passes: dict = {}

    def draws(self, generator: torch.Generator, sz: int, aux0) -> DPDraws:
        """The draws of one build of size ``sz`` from ``generator``, in the
        order of ``DPDraws``'s fields."""
        data, (N, D) = self.data, self.data.shape
        dt, dev = data.dtype, data.device
        T, S = self.step_sizes.shape[0], self.projection_dim
        e1 = torch.randn(D, generator=generator, dtype=dt, device=dev)
        e2 = torch.randn((sz, D), generator=generator, dtype=dt, device=dev)
        w = torch.zeros(sz, dtype=dt, device=dev)
        z = self.sampler.draw_noise(generator, T * S, w, e2, aux0).reshape(T, S, -1)
        if self.poisson:
            batch = torch.rand((T, N), generator=generator, dtype=dt, device=dev) < self.q
        else:
            batch = torch.stack([torch.randperm(N, generator=generator, device=dev)[:self.n_opt]
                                 for _ in range(T)])
        noise = torch.randn((T, S), generator=generator, dtype=dt, device=dev)
        return DPDraws(e1, e2, z, batch, noise)

    def private_init(self, init_noise, init_scatter):
        """The initial pseudo-points: the clipped data mean released with
        noise of std noise_multiplier * 2 * init_clip_norm / N (the
        substitution sensitivity of the mean times the multiplier), plus
        the public ``init_spread`` scatter."""
        data, N, dp = self.data, self.data.shape[0], self.dp
        c_init = dp.init_clip_norm
        row_norms = torch.linalg.norm(data, dim=1, keepdim=True)
        clipped = data * torch.clamp_max(c_init / torch.clamp_min(row_norms, 1e-12), 1.0)
        mean = clipped.sum(dim=0) / N + (dp.noise_multiplier * 2.0 * c_init / N) * init_noise
        return mean + dp.init_spread * init_scatter

    def build(self, draws, sz: int, aux0):
        data, N = self.data, self.data.shape[0]
        dt, dev = data.dtype, data.device
        aux0 = aux0.to(dev)
        if isinstance(draws, torch.Generator):
            draws = self.draws(draws, sz, aux0)
        e1, e2, z_all, batch_all, noise_all = (t.to(dev) for t in draws)
        pts0 = self.private_init(e1, e2)
        w0 = torch.full((sz,), N / sz, dtype=dt, device=dev)
        p = self._passes.get(sz)
        if p is None or not (p.serves(sz, z_all, aux0) and p.batch_all.shape == batch_all.shape):
            p = self._passes[sz] = DPPass(self, sz, z_all, aux0, batch_all,
                                          PassRunner(self.graph))
        p.fill(w0, pts0, torch.ones(sz, dtype=dt, device=dev), aux0, z_all)
        p.batch_all.copy_(batch_all)
        p.noise_all.copy_(noise_all)
        p.run()
        return p.result()

    __call__ = build


def make_dp_bpsvi_builder(data: torch.Tensor, model, sampler, config: BPSVIConfig,
                          dp: DPConfig, step_sizes=None,
                          graph: Optional[bool] = None) -> DPBPSVIBuilder:
    """The DP-BPSVI builder over ``data`` (N, D) on its device; the
    returned coreset holds pseudo-points only."""
    if getattr(model, "grad_z_log_likelihood", None) is None:
        raise ValueError("DP-BPSVI needs model.grad_z_log_likelihood")
    if not noise_split(sampler):
        raise ValueError("DP-BPSVI draws a pass's noise ahead: the sampler needs "
                         "draw_noise and from_noise")
    if step_sizes is None:
        step_sizes = step_schedule(config.i0, config.opt_itrs, dtype=data.dtype,
                                   device=data.device)
    step_sizes = torch.as_tensor(step_sizes, dtype=data.dtype, device=data.device)
    return DPBPSVIBuilder(data, model, sampler, config, dp, step_sizes, graph)


class DiffPrivBatchPSVICoreset:
    """The eager object (the class the reference exports but does not
    ship), shaped like ``BatchPSVICoreset``; ``get()`` returns (wts, pts)
    only. Runs on the card unless given ``device="cpu"``."""

    def __init__(self, data, ll_projector, opt_itrs: int = 100, n_subsample_opt=None,
                 step_sched: Callable = lambda m: (lambda i: 1.0 / (1.0 + i)),
                 clip_norm: float = 1.0, noise_multiplier: float = 1.0,
                 delta: float = 1e-5, seed: int = 0, init_clip_norm: float = 10.0,
                 init_spread: float = 1.0, sampling: str = "poisson", device=None,
                 graph: Optional[bool] = None):
        self.device = resolve_device(device)
        self.data = _as_data(data, self.device)
        self.projector = ll_projector
        self.opt_itrs = opt_itrs
        self.n_subsample_opt = n_subsample_opt
        self.step_sched = step_sched
        self.graph = graph
        self.dp = DPConfig(clip_norm=clip_norm, noise_multiplier=noise_multiplier,
                           delta=delta, init_clip_norm=init_clip_norm,
                           init_spread=init_spread, sampling=sampling)
        self.keys = KeySequence(seed, self.device)
        self.wts = np.zeros(0)
        self.pts = np.zeros((0, self.data.shape[1]))
        self._builders: dict = {}

    def epsilon(self, delta: Optional[float] = None) -> float:
        """(eps, delta) of one completed build: Poisson, the subsampled
        Gaussian accountant under add/remove (overflow charged to delta);
        swr, the unamplified substitution bound."""
        delta = delta if delta is not None else self.dp.delta
        if self.dp.sampling == "poisson":
            N = self.data.shape[0]
            n_opt = min(N, self.n_subsample_opt) if self.n_subsample_opt else N
            q = n_opt / N
            return subsampled_gaussian_epsilon(self.opt_itrs, q, self.dp.noise_multiplier,
                                               delta, n=N, cap=poisson_batch_cap(N, q))
        return gaussian_rdp_epsilon(self.opt_itrs, self.dp.noise_multiplier, delta)

    def _builder_for(self, sz: int) -> DPBPSVIBuilder:
        if sz not in self._builders:
            steps = _steps_to_i0(self.step_sched(sz), self.opt_itrs)
            cfg = BPSVIConfig(projection_dim=self.projector.projection_dimension,
                              n_subsample_opt=self.n_subsample_opt, opt_itrs=self.opt_itrs)
            self._builders[sz] = make_dp_bpsvi_builder(
                self.data, self.projector.model, self.projector.sampler, cfg, self.dp,
                step_sizes=torch.from_numpy(steps), graph=self.graph)
        return self._builders[sz]

    def _init_aux(self) -> torch.Tensor:
        td = getattr(self.projector, "theta_dim", None)
        return torch.zeros(td or self.data.shape[1], dtype=self.data.dtype,
                           device=self.device)

    def _draws(self, sz: int):
        """The draws of one ``build``: the next generator of this
        instance's key sequence."""
        return self.keys()

    def build(self, itrs: int, sz: int) -> None:
        w, p = self._builder_for(sz)(self._draws(sz), sz, self._init_aux())
        self.wts, self.pts = w.cpu().numpy(), p.cpu().numpy()

    def get(self):
        keep = self.wts > 0
        return self.wts[keep], self.pts[keep]

    def size(self) -> int:
        return int((self.wts > 0).sum())
