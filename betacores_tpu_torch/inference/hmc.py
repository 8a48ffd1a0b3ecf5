"""Adaptive multinomial HMC for coreset-posterior evaluation (counterpart of
betacores_tpu/inference/hmc.py).

The target is the weighted coreset posterior
log p(th) = log prior(th) + sum_m w_m loglik(z_m | th). Each iteration draws
L ~ U{1..L_max} leapfrog steps, puts the current state at a uniform offset
j ~ U{0..L} of the trajectory, and picks one of its L + 1 states by
progressive multinomial (reservoir) sampling under exp(-H); the warmup
dual-averages the step size to a target acceptance statistic and estimates a
diagonal mass matrix, in two windows as Stan does.

Where the reference vmaps chains over one jitted program, the port runs the
C chains as one batch, ``logprob`` mapping a (C, d) batch to (C,): the
gradient of the summed log densities is each chain's gradient, so one
backward pass of autograd serves every chain (``make_precise_logprob_and_grad``).
The randomness is drawn apart from the compute, every phase's up front
(``HMCDraws``, ``draw_hmc``): a runner takes a ``torch.Generator`` on the
device of its tensors, or the draws themselves (the tests feed the JAX
package's). Every iteration runs the same static L_max-step body, masked
past L, reading its draws and the iteration index from the device, so on a
CUDA device each kind of iteration (warmup A, warmup B, sampling) is
captured once as a CUDA graph and replayed (``utils/graphs.py``); elsewhere,
or with ``graph=False``, the same body runs eagerly. ``run_chains_sharded``
splits the chains over a mesh's ranks, each rank running its block as one
batch.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.device import resolve_device
from ..utils.graphs import PassRunner, resolve_graph


class HMCConfig(NamedTuple):
    n_samples: int = 1000
    n_warmup: int = 1000
    L_max: int = 32
    target_accept: float = 0.8
    init_step_size: float = 0.1
    # dual averaging constants (Hoffman & Gelman 2014, as in Stan)
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75


class HMCPhaseDraws(NamedTuple):
    """One phase's randomness for C chains over n iterations."""

    z: torch.Tensor      # (n, C, d) standard normals: the momentum
    L: torch.Tensor      # (n, C) int64 path lengths in 1..L_max
    j: torch.Tensor      # (n, C) int64 backward steps in 0..L (drawn after L)
    u: torch.Tensor      # (n, C, L_max) uniforms of the reservoir


class HMCDraws(NamedTuple):
    init: Optional[torch.Tensor]   # (C, d) normals of the init jitter, None for one chain
    phases: tuple                  # (warmup A, warmup B, sampling) phase draws


def phase_lengths(cfg) -> tuple:
    """Iterations of warmup A, warmup B and sampling."""
    n_a = cfg.n_warmup // 2
    return n_a, cfg.n_warmup - n_a, cfg.n_samples


def draw_hmc(generator: torch.Generator, n_chains: int, d: int, cfg: HMCConfig,
             dtype: torch.dtype = torch.float32, init: bool = True) -> HMCDraws:
    """Every phase's draws, up front, on the generator's device: the init
    jitter's normals (``init``), then per phase the momenta, L, the offset
    j = floor(u (L + 1)) of a uniform u, and the reservoir's uniforms."""
    dev, C = generator.device, n_chains
    kw = dict(generator=generator, dtype=dtype, device=dev)
    init_z = torch.randn((C, d), **kw) if init else None
    phases = []
    for n in phase_lengths(cfg):
        z = torch.randn((n, C, d), **kw)
        L = torch.randint(1, cfg.L_max + 1, (n, C), generator=generator, device=dev)
        j = torch.floor(torch.rand((n, C), **kw) * (L + 1)).long()
        phases.append(HMCPhaseDraws(z, L, torch.minimum(j, L), torch.rand((n, C, cfg.L_max), **kw)))
    return HMCDraws(init_z, tuple(phases))


@contextlib.contextmanager
def highest_matmul_precision():
    """float32 products in full float32 (no TF32) inside, restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def make_precise_logprob_and_grad(logprob: Callable) -> Callable:
    """``th (C, d) -> (logprob (C,), gradient (C, d))`` by autograd, with
    the target's products in full float32: leapfrog energies on sharply
    curved posteriors do not survive TF32's ~1e-3 relative error (the
    reference forces XLA's highest precision for the same reason)."""

    def logprob_and_grad(th):
        with highest_matmul_precision(), torch.enable_grad():
            x = th.detach().requires_grad_(True)
            lp = logprob(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    return logprob_and_grad


def _leapfrog_trajectory(draws, logprob_and_grad, theta, eps, L, L_max: int, inv_mass):
    """One multinomial HMC transition of C chains over a length-L trajectory
    that holds the current state at offset j: j steps backward (negated
    momentum), then from the seed L - j forward, in one static run of L_max
    leapfrog steps masked past L. ``draws`` = (z (C, d), j (C,), u (C,
    L_max)); theta, inv_mass (C, d); eps, L (C,). Returns (theta', accept
    statistic (C,))."""
    z, j, u = draws
    p0 = z / torch.sqrt(inv_mass)
    lp0, g0 = logprob_and_grad(theta)
    H0 = -lp0 + 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    half_eps = 0.5 * eps[:, None]
    eps_m = eps[:, None] * inv_mass
    logu = torch.log(u)
    inf = torch.full_like(lp0, math.inf)
    ninf, zero = -inf, torch.zeros_like(lp0)
    th, p, g, chosen = theta, -p0, g0, theta
    logw_tot, acc_sum = zero, zero     # the seed's log weight is -(H0 - H0) = 0
    for s in range(L_max):
        active = L > s
        reset = (j == s)[:, None]      # the end of the backward phase
        th = torch.where(reset, theta, th)
        p = torch.where(reset, p0, p)
        g = torch.where(reset, g0, g)
        p_half = p + half_eps * g
        th_new = th + eps_m * p_half
        lp_new, g_new = logprob_and_grad(th_new)
        p_new = p_half + half_eps * g_new
        H = -lp_new + 0.5 * torch.sum(inv_mass * p_new * p_new, dim=-1)
        H = torch.where(torch.isfinite(H), H, inf)
        logw = -(H - H0)
        logw_new_tot = torch.logaddexp(logw_tot, torch.where(active, logw, ninf))
        take = (logu[:, s] < (logw - logw_new_tot)) & active
        chosen = torch.where(take[:, None], th_new, chosen)
        acc_sum = acc_sum + torch.where(active, torch.clamp_max(torch.exp(logw), 1.0), zero)
        a = active[:, None]
        th = torch.where(a, th_new, th)
        p = torch.where(a, p_new, p)
        g = torch.where(a, g_new, g)
        logw_tot = logw_new_tot
    return chosen, acc_sum / torch.clamp_min(L.to(theta.dtype), 1.0)


def _load(buffers, draws) -> None:
    """Copies injected or freshly drawn phase draws into static buffers."""
    for buf, new in zip(buffers, draws):
        for b, x in zip(buf, new):
            if tuple(b.shape) != tuple(x.shape):
                raise ValueError(f"draws of shape {tuple(x.shape)}, want {tuple(b.shape)}")
            b.copy_(x)


class _HMCKernel:
    """The HMC transition on static per-phase draw buffers: one graph an
    iteration."""

    def __init__(self, logprob_and_grad, C: int, d: int, cfg, dtype, device):
        self.lpg, self.L_max = logprob_and_grad, cfg.L_max
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        i = lambda *s: torch.zeros(s, dtype=torch.long, device=device)
        self.draws = [HMCPhaseDraws(f(n, C, d), i(n, C), i(n, C), f(n, C, cfg.L_max))
                      for n in phase_lengths(cfg)]

    def load(self, phases) -> None:
        _load(self.draws, phases)

    def extras(self, n: int) -> tuple:
        return ()

    def summarize(self, extras) -> dict:
        return {}

    def transition(self, st, phase: int) -> None:
        def body():
            D = self.draws[phase]
            at = lambda x: x.index_select(0, st.i)[0]
            th, astat = _leapfrog_trajectory((at(D.z), at(D.j), at(D.u)), self.lpg, st.th,
                                             st.eps, at(D.L), self.L_max, st.inv_mass)
            st.adapt(phase, th, astat, ())

        st.runner.run(("hmc", phase), body)


class _Adaptive:
    """Static buffers of an adaptive run of C chains around a transition
    kernel (``_HMCKernel``, nuts.py's ``_NUTSKernel``), and the runner of its
    graphs. Phase A dual-averages the step size under the identity mass and
    collects a Welford variance over its second half; phase B re-adapts the
    step size under that diagonal mass, its dual averaging re-anchored at 10x
    phase A's adapted step; then sampling at the averaged step."""

    def __init__(self, kernel, C: int, d: int, cfg, dtype, device, graph: bool):
        self.kernel, self.cfg = kernel, cfg
        self.runner = PassRunner(graph)
        self.lengths = phase_lengths(cfg)
        n_a, n_b, n_s = self.lengths
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        self.th, self.inv_mass, self.mean, self.m2 = f(C, d), f(C, d), f(C, d), f(C, d)
        self.eps, self.logeps, self.logeps_bar, self.h_bar, self.mu = (f(C) for _ in range(5))
        self.i = torch.zeros(1, dtype=torch.long, device=device)
        self.wu_astat, self.astat, self.samples = f(n_a + n_b, C), f(n_s, C), f(C, n_s, d)
        self.extras = kernel.extras(n_s)

    def adapt(self, phase: int, th, astat, extras) -> None:
        """The end of iteration ``self.i`` of ``phase``: in warmup the dual
        averaging (and in phase A the Welford update), in sampling the
        record; then the iteration index moves on. Runs inside the
        iteration's last graph."""
        cfg, i = self.cfg, self.i
        self.th.copy_(th)
        if phase == 2:
            self.samples.index_copy_(1, i, th[:, None])
            self.astat.index_copy_(0, i, astat[None])
            for buf, x in zip(self.extras, extras):
                buf.index_copy_(0, i, x[None])
        else:
            t = i.to(th.dtype) + 1.0
            eta = 1.0 / (t + cfg.da_t0)
            h_bar = (1.0 - eta) * self.h_bar + eta * (cfg.target_accept - astat)
            logeps = self.mu - torch.sqrt(t) / cfg.da_gamma * h_bar
            w = t ** (-cfg.da_kappa)
            self.logeps_bar.copy_(w * logeps + (1.0 - w) * self.logeps_bar)
            self.h_bar.copy_(h_bar)
            self.logeps.copy_(logeps)
            self.eps.copy_(torch.exp(logeps))
            if phase == 0:
                half = self.lengths[0] // 2
                in_window = (i >= half)[:, None]
                cnt = torch.clamp_min(t - half, 1.0)[:, None]
                delta = th - self.mean
                mean = torch.where(in_window, self.mean + delta / cnt, self.mean)
                self.m2.copy_(torch.where(in_window, self.m2 + delta * (th - mean), self.m2))
                self.mean.copy_(mean)
            self.wu_astat.index_copy_(0, i + (0 if phase == 0 else self.lengths[0]), astat[None])
        i.add_(1)

    def _phase(self, phase: int) -> None:
        self.i.zero_()
        for _ in range(self.lengths[phase]):
            self.kernel.transition(self, phase)

    def run(self, theta_init, phases) -> tuple:
        """(samples (C, n_samples, d), per-chain stats) from ``theta_init``
        (C, d) under the phases' draws."""
        cfg, n_a = self.cfg, self.lengths[0]
        self.kernel.load(phases)
        self.th.copy_(theta_init)
        self.logeps.copy_(torch.log(torch.full_like(self.logeps, cfg.init_step_size)))
        self.logeps_bar.copy_(self.logeps)
        self.eps.copy_(torch.exp(self.logeps))
        self.mu.fill_(math.log(10.0 * cfg.init_step_size))
        for x in (self.h_bar, self.mean, self.m2):
            x.zero_()
        self.inv_mass.fill_(1.0)
        self._phase(0)
        var = self.m2 / max(n_a - n_a // 2 - 1.0, 1.0)
        self.inv_mass.copy_(torch.where(var > 1e-10, var, torch.ones_like(var)))
        self.logeps.copy_(self.logeps_bar)
        self.h_bar.zero_()
        self.mu.copy_(self.logeps_bar + math.log(10.0))
        self.eps.copy_(torch.exp(self.logeps))
        self._phase(1)
        self.eps.copy_(torch.exp(self.logeps_bar))
        self._phase(2)
        stats = {"step_size": self.eps.clone(), "accept_stat": self.astat.mean(dim=0),
                 "inv_mass": self.inv_mass.clone(), "warmup_accept": self.wu_astat.mean(dim=0),
                 **self.kernel.summarize(self.extras)}
        return self.samples.clone(), stats


def adaptive_mcmc(kernel, theta_init, phases, cfg, graph: Optional[bool] = None) -> tuple:
    """Stan-style adaptive sampling of C chains from ``theta_init`` (C, d)
    around a transition kernel (``_HMCKernel``, nuts.py's ``_NUTSKernel``)
    under the phases' draws: (samples (C, n_samples, d), per-chain stats,
    with the kernel's own under its names)."""
    C, d = theta_init.shape
    run = _Adaptive(kernel, C, d, cfg, theta_init.dtype, theta_init.device,
                    resolve_graph(graph, theta_init.device))
    return run.run(theta_init, phases)


def _as_theta(theta0) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to the card
    (``resolve_device``)."""
    if isinstance(theta0, torch.Tensor):
        return theta0
    return torch.as_tensor(theta0, device=resolve_device(None))


def _chain_inits(theta0, draws) -> torch.Tensor:
    """theta0 jittered per chain: theta0 + 0.1 N(0, I)."""
    return theta0 + 0.1 * draws.init.to(theta0)


def _squeeze(samples, stats) -> tuple:
    return samples[0], {k: v[0] for k, v in stats.items()}


def run_chains(key, logprob: Callable, theta0, n_chains: int = 1,
               config: HMCConfig = HMCConfig(), graph: Optional[bool] = None):
    """C adaptive HMC chains from theta0 (d,) jittered per chain.
    ``logprob`` maps (C, d) to (C,); ``key`` is a ``torch.Generator`` on
    theta0's device or an ``HMCDraws``. Returns ((C, n_samples, d) draws,
    per-chain stats); feed the draws to ``diagnostics.summarize_chains``."""
    theta0 = _as_theta(theta0)
    d = theta0.shape[-1]
    draws = (draw_hmc(key, n_chains, d, config, theta0.dtype)
             if isinstance(key, torch.Generator) else key)
    kernel = _HMCKernel(make_precise_logprob_and_grad(logprob), n_chains, d, config,
                        theta0.dtype, theta0.device)
    return adaptive_mcmc(kernel, _chain_inits(theta0, draws), draws.phases, config,
                         graph)


def hmc_sample(key, logprob: Callable, theta0, config: HMCConfig = HMCConfig(),
               graph: Optional[bool] = None):
    """One adaptive HMC chain from theta0 (d,), ``logprob`` mapping (1, d)
    to (1,). ``key``: a generator or an ``HMCDraws`` of one chain (its
    ``init`` unused). Returns ((n_samples, d) draws, stats)."""
    theta0 = _as_theta(theta0)
    d = theta0.shape[-1]
    draws = (draw_hmc(key, 1, d, config, theta0.dtype, init=False)
             if isinstance(key, torch.Generator) else key)
    kernel = _HMCKernel(make_precise_logprob_and_grad(logprob), 1, d, config, theta0.dtype,
                        theta0.device)
    return _squeeze(*adaptive_mcmc(kernel, theta0[None], draws.phases, config, graph))


def _chains_of(draws, idx: torch.Tensor):
    """The draws of chains ``idx`` of a batch's ``HMCDraws`` or
    ``NUTSDraws`` (each phase's fields carry the chain axis second)."""
    phases = tuple(type(p)(*(x.index_select(1, idx.to(x.device)) for x in p))
                   for p in draws.phases)
    init = None if draws.init is None else draws.init.index_select(0, idx.to(draws.init.device))
    return type(draws)(init, phases)


def run_chains_sharded(key, logprob: Callable, theta0, n_chains: int, mesh,
                       config=HMCConfig(), graph: Optional[bool] = None):
    """``run_chains`` with the chains split over every rank of ``mesh``
    (the reference's lane sharding, as the BPSVI sizes): rank r runs the
    r-th contiguous block of chains as one batch, on the mesh's device, with
    no collective until one gather over both axes brings every chain's
    samples and stats to every rank. The chains are padded up to a multiple
    of the rank count with lanes started at theta0, dropped before
    returning. ``key``: a ``torch.Generator`` on the mesh's device, seeded
    alike on every rank, from which every rank draws all ``n_chains``'
    draws as ``run_chains`` does and keeps its own (the padding lanes
    replay chain 0's), or those draws themselves; chain i is then
    ``run_chains``'s chain i. Given a ``nuts.NUTSConfig`` it runs NUTS
    chains, as ``nuts.run_chains_nuts``. Returns ((n_chains, n_samples, d)
    draws, per-chain stats)."""
    from ..parallel.mesh import gather_lanes, lane_block, require_axes
    from .nuts import _NUTSKernel, draw_nuts

    require_axes(mesh)
    theta0 = _as_theta(theta0).to(mesh.device)
    d = theta0.shape[-1]
    nuts = hasattr(config, "max_treedepth")
    draw, make = (draw_nuts, _NUTSKernel) if nuts else (draw_hmc, _HMCKernel)
    draws = (draw(key, n_chains, d, config, theta0.dtype)
             if isinstance(key, torch.Generator) else key)
    _, lo, per = lane_block(n_chains, mesh)
    lanes = torch.arange(lo, lo + per, device=mesh.device)
    live = lanes < n_chains
    mine = _chains_of(draws, torch.where(live, lanes, 0))
    inits = torch.where(live[:, None], _chain_inits(theta0, mine), theta0)
    kernel = make(make_precise_logprob_and_grad(logprob), per, d, config, theta0.dtype,
                  mesh.device)
    samples, stats = adaptive_mcmc(kernel, inits, mine.phases, config, graph)
    names = list(stats)
    out = gather_lanes(mesh, [samples] + [stats[k] for k in names], n_chains)
    return out[0], dict(zip(names, out[1:]))


class _WeightedRunner:
    """Adaptive runs over a weighted posterior ``log_joint(Z, th, w)`` with
    (Z, w) in static buffers: one runner, and on a card one set of graphs,
    per (shape, dtype, device, chains, config, graph), reused by every
    same-shape coreset (zero-weight padding rows are inert, so pad sizes to
    one capacity)."""

    def __init__(self, log_joint: Callable, make_kernel: Callable, draw: Callable):
        self.log_joint, self.make_kernel, self.draw = log_joint, make_kernel, draw
        self.cache: dict = {}

    def __call__(self, key, Z, w, theta0, n_chains: int, config, graph, init: bool):
        theta0 = _as_theta(theta0)
        dtype, dev, d = theta0.dtype, theta0.device, theta0.shape[-1]
        Z = torch.as_tensor(Z, dtype=dtype, device=dev)
        w = torch.as_tensor(w, dtype=dtype, device=dev)
        graph = resolve_graph(graph, dev)
        sig = (tuple(Z.shape), tuple(w.shape), dtype, dev, n_chains, config, graph, init)
        if sig not in self.cache:
            Zb, wb = torch.empty_like(Z), torch.empty_like(w)
            lpg = make_precise_logprob_and_grad(lambda th: self.log_joint(Zb, th, wb))
            kernel = self.make_kernel(lpg, n_chains, d, config, dtype, dev)
            self.cache[sig] = (_Adaptive(kernel, n_chains, d, config, dtype, dev, graph), Zb, wb)
        run, Zb, wb = self.cache[sig]
        Zb.copy_(Z)
        wb.copy_(w)
        draws = (self.draw(key, n_chains, d, config, dtype, init=init)
                 if isinstance(key, torch.Generator) else key)
        inits = _chain_inits(theta0, draws) if init else theta0[None]
        return run.run(inits, draws.phases)


def make_weighted_hmc(log_joint: Callable):
    """Weighted-posterior HMC for any model's ``log_joint(Z, theta, w)``
    (theta (C, d) -> (C,)), with the coreset (Z, w) as arguments. Returns
    ``(sample, chains)``: ``sample(key, Z, w, theta0, config, graph=None)``
    -> ((n, d) draws, stats); ``chains(key, Z, w, theta0, n_chains,
    config, graph=None)`` -> ((C, n, d) draws, per-chain stats)."""
    runner = _WeightedRunner(log_joint, _HMCKernel, draw_hmc)

    def sample(key, Z, w, theta0, config: HMCConfig = HMCConfig(), graph=None):
        return _squeeze(*runner(key, Z, w, theta0, 1, config, graph, init=False))

    def chains(key, Z, w, theta0, n_chains: int = 2, config: HMCConfig = HMCConfig(),
               graph=None):
        return runner(key, Z, w, theta0, n_chains, config, graph, init=True)

    return sample, chains


def weighted_logreg_logprob(Z, w) -> Callable:
    """The weighted Bayesian-logreg evaluation target (the reference's
    weighted Stan program)."""
    from ..models import logreg

    return lambda th: logreg.log_joint(Z, th, w)


_LOGREG_HMC = None
_POISSON_HMC = None


def _logreg_hmc():
    global _LOGREG_HMC
    if _LOGREG_HMC is None:
        from ..models import logreg

        _LOGREG_HMC = make_weighted_hmc(logreg.log_joint)
    return _LOGREG_HMC


def _poisson_hmc():
    global _POISSON_HMC
    if _POISSON_HMC is None:
        from ..models import poisson

        _POISSON_HMC = make_weighted_hmc(poisson.log_joint)
    return _POISSON_HMC


def hmc_sample_weighted_logreg(key, Z, w, theta0, config: HMCConfig = HMCConfig(), graph=None):
    """Weighted-logreg HMC, one chain (see ``make_weighted_hmc``)."""
    return _logreg_hmc()[0](key, Z, w, theta0, config, graph)


def run_chains_weighted_logreg(key, Z, w, theta0, n_chains: int = 2,
                               config: HMCConfig = HMCConfig(), graph=None):
    """Multi-chain weighted-logreg HMC (see ``make_weighted_hmc``)."""
    return _logreg_hmc()[1](key, Z, w, theta0, n_chains, config, graph)


def hmc_sample_weighted_poisson(key, Z, w, theta0, config: HMCConfig = HMCConfig(), graph=None):
    """Weighted-Poisson HMC, one chain: the weighted extension of the
    reference's Poisson Stan program."""
    return _poisson_hmc()[0](key, Z, w, theta0, config, graph)


def run_chains_weighted_poisson(key, Z, w, theta0, n_chains: int = 2,
                                config: HMCConfig = HMCConfig(), graph=None):
    """Multi-chain weighted-Poisson HMC (see ``make_weighted_hmc``)."""
    return _poisson_hmc()[1](key, Z, w, theta0, n_chains, config, graph)


def hmc_sample_full_logreg(key, Z, theta0, config: HMCConfig = HMCConfig(),
                           n_subsample: int = 5000, idx=None, graph=None):
    """The full-data logreg posterior by HMC on a uniform subsample of
    ``n_subsample`` rows drawn with replacement, unit weights; the whole
    data when ``n_subsample >= N``. ``key``: a generator (the indices are
    drawn first, then the HMC draws) or an ``HMCDraws`` with the indices
    given as ``idx``. Returns (samples, stats)."""
    N = Z.shape[0]
    n = min(n_subsample, N)
    if n >= N:
        Zs = Z
    else:
        if idx is None:
            idx = torch.randint(0, N, (n,), generator=key, device=key.device)
        Zs = Z[torch.as_tensor(idx, device=Z.device)]
    return hmc_sample_weighted_logreg(key, Zs, torch.ones(n, dtype=Zs.dtype, device=Zs.device),
                                      theta0, config, graph)
