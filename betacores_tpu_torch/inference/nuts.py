"""Dynamic-trajectory NUTS in the iterative formulation (counterpart of
betacores_tpu/inference/nuts.py).

Multinomial NUTS (Betancourt 2017) as the reference writes it: the
trajectory doubles up to ``max_treedepth`` times, each doubling integrating
2^depth leapfrog steps in a random direction from that trajectory edge;
the proposal is progressive multinomial sampling with the biased doubling
acceptance min(1, W_new / W_old); U-turns are checked across the whole
trajectory after each doubling and inside every subtree through the
checkpoint bit-trick (leaf j, even, stored at slot popcount(j); odd leaf i
checks the slots popcount(i >> 1) - tz(i + 1) + 1 .. popcount(i >> 1));
a leaf with energy error dH > ``divergence_threshold`` marks the draw
divergent and stops it. Only a completed doubling counts toward the depth.
Warmup and sampling are hmc.py's adaptive loop.

The reference vmaps ``lax.while_loop``s over chains; here the C chains run
as one batch and a chain that has stopped stays frozen under masks, as the
vmapped loop keeps it. A doubling at depth t is one static body of 2^t
leaves (a leaf's slot and checks are known on the host, so only the live
checks run), the in-subtree stop a per-chain mask; on a CUDA device each
depth is captured once as a CUDA graph, as are the draw's first and last
parts. After each doubling the host reads whether every chain is done: at
most ``max_treedepth`` graphs and reads a draw, one graph and one read per
completed doubling. The draws of a phase are made up front: per draw the
momentum, and per doubling the direction, the swap uniform and its 2^t leaf
uniforms (``NUTSDraws``); the tests feed the JAX package's.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, NamedTuple, Optional

import torch

from .hmc import (_as_theta, _chain_inits, _load, _squeeze, _WeightedRunner, adaptive_mcmc,
                  make_precise_logprob_and_grad, phase_lengths)


class NUTSConfig(NamedTuple):
    n_samples: int = 1000
    n_warmup: int = 1000
    max_treedepth: int = 10
    target_accept: float = 0.8     # the reference runs Stan at 0.9
    init_step_size: float = 0.1
    divergence_threshold: float = 1000.0
    # dual averaging constants (shared semantics with HMCConfig)
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75


class NUTSPhaseDraws(NamedTuple):
    """One phase's randomness for C chains over n draws, T = max_treedepth."""

    z: torch.Tensor       # (n, C, d) standard normals: the momentum
    right: torch.Tensor   # (n, C, T) bool: doubling t extends to the right
    swap: torch.Tensor    # (n, C, T) uniforms of the doubling acceptance
    leaf: torch.Tensor    # (n, C, 2^T - 1) leaf uniforms, doubling t's 2^t at 2^t - 1


class NUTSDraws(NamedTuple):
    init: Optional[torch.Tensor]   # (C, d) normals of the init jitter, None for one chain
    phases: tuple                  # (warmup A, warmup B, sampling) phase draws


def draw_nuts(generator: torch.Generator, n_chains: int, d: int, cfg: NUTSConfig,
              dtype: torch.dtype = torch.float32, init: bool = True) -> NUTSDraws:
    """Every phase's draws, up front, on the generator's device."""
    dev, C, T = generator.device, n_chains, cfg.max_treedepth
    kw = dict(generator=generator, dtype=dtype, device=dev)
    init_z = torch.randn((C, d), **kw) if init else None
    phases = tuple(NUTSPhaseDraws(torch.randn((n, C, d), **kw), torch.rand((n, C, T), **kw) < 0.5,
                                  torch.rand((n, C, T), **kw), torch.rand((n, C, 2 ** T - 1), **kw))
                   for n in phase_lengths(cfg))
    return NUTSDraws(init_z, phases)


def _popcount(x):
    """Set bits of the low 32 bits of ``x`` (an int or an integer tensor)."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64) & 0xFFFFFFFF
        return sum((x >> k) & 1 for k in range(32)).to(torch.int32)
    return bin(x & 0xFFFFFFFF).count("1")


def _trailing_zeros(x):
    """tz(x) = popcount((x & -x) - 1); 32 for x = 0."""
    return _popcount((x & -x) - 1)


class _Tree(NamedTuple):
    """A draw's trajectory state, per chain."""

    depth: torch.Tensor      # (C,) int64 completed doublings
    th_l: torch.Tensor       # (C, d) left edge: position, momentum, gradient
    p_l: torch.Tensor
    g_l: torch.Tensor
    th_r: torch.Tensor       # (C, d) right edge
    p_r: torch.Tensor
    g_r: torch.Tensor
    prop: torch.Tensor       # (C, d) the proposal
    logw: torch.Tensor       # (C,) log total weight
    acc_sum: torch.Tensor    # (C,) acceptance statistics' sum and count
    n_acc: torch.Tensor
    diverged: torch.Tensor   # (C,) bool
    done: torch.Tensor       # (C,) bool


def _tree_init(logprob_and_grad, theta, z, inv_mass) -> tuple:
    """(the one-state trajectory at theta with momentum z / sqrt(inv_mass),
    its energy H0)."""
    p0 = z / torch.sqrt(inv_mass)
    lp0, g0 = logprob_and_grad(theta)
    H0 = -lp0 + 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    zero, no = torch.zeros_like(lp0), torch.zeros_like(lp0, dtype=torch.bool)
    depth = torch.zeros_like(lp0, dtype=torch.long)
    return _Tree(depth, theta, p0, g0, theta, p0, g0, theta, zero, zero, zero, no, no), H0


def _doubling(logprob_and_grad, tree: _Tree, H0, t: int, go_right, swap_u, leaf_u, eps,
              inv_mass, div_thresh: float) -> _Tree:
    """Doubling t of every chain not yet done (all of them at depth t): a
    subtree of 2^t leaves from the edge in direction ``go_right`` (C,),
    its in-subtree stop a mask, then the biased acceptance, the edge update
    and the full-trajectory U-turn. ``leaf_u`` (C, 2^t), ``swap_u`` (C,)."""
    active = ~tree.done
    one = torch.ones_like(H0)
    direction = torch.where(go_right, one, -one)
    eps_v = direction * eps
    half_eps, eps_m = 0.5 * eps_v[:, None], eps_v[:, None] * inv_mass
    dcol, r = direction[:, None], go_right[:, None]
    th = torch.where(r, tree.th_r, tree.th_l)
    p = torch.where(r, tree.p_r, tree.p_l)
    g = torch.where(r, tree.g_r, tree.g_l)
    logu = torch.log(leaf_u)
    logw_sub, prop = torch.full_like(H0, -math.inf), th
    acc, nacc = torch.zeros_like(H0), torch.zeros_like(H0)
    div = turning = torch.zeros_like(active)
    stop = ~active
    ck = {}
    for i in range(2 ** t):
        live = ~stop
        p_half = p + half_eps * g
        th_n = th + eps_m * p_half
        lp_n, g_n = logprob_and_grad(th_n)
        p_n = p_half + half_eps * g_n
        H = -lp_n + 0.5 * torch.sum(inv_mass * p_n * p_n, dim=-1)
        H = torch.where(torch.isfinite(H), H, torch.full_like(H, math.inf))
        dH = H - H0
        div_n = dH > div_thresh
        logw = -dH
        lws = torch.logaddexp(logw_sub, logw)
        take = (logu[:, i] < (logw - lws)) & ~div_n
        prop_n = torch.where(take[:, None], th_n, prop)
        acc_n = acc + torch.clamp_max(torch.exp(torch.clamp_max(logw, 0.0)), 1.0)
        turn_n = turning
        if i % 2 == 0:
            ck[_popcount(i)] = (th_n, p_n)
        else:
            v_n = inv_mass * p_n
            hi = _popcount(i >> 1)
            for slot in range(max(hi - _trailing_zeros(i + 1) + 1, 0), hi + 1):
                th_c, p_c = ck[slot]
                dth = dcol * (th_n - th_c)
                turn_n = (turn_n | (torch.sum(dth * (inv_mass * p_c), dim=-1) < 0)
                          | (torch.sum(dth * v_n, dim=-1) < 0))
        lv = live[:, None]
        th, p, g = torch.where(lv, th_n, th), torch.where(lv, p_n, p), torch.where(lv, g_n, g)
        logw_sub = torch.where(live, lws, logw_sub)
        prop = torch.where(lv, prop_n, prop)
        acc = torch.where(live, acc_n, acc)
        nacc = nacc + live.to(nacc.dtype)
        div = div | (live & div_n)
        turning = torch.where(live, turn_n, turning)
        stop = stop | (live & (div_n | turn_n))
    ok = ~(div | turning)
    take = torch.log(swap_u) < (logw_sub - tree.logw)
    prop = torch.where((ok & take)[:, None], prop, tree.prop)
    logw = torch.where(ok, torch.logaddexp(tree.logw, logw_sub), tree.logw)
    ur, ul = (ok & go_right)[:, None], (ok & ~go_right)[:, None]
    th_r, p_r, g_r = (torch.where(ur, th, tree.th_r), torch.where(ur, p, tree.p_r),
                      torch.where(ur, g, tree.g_r))
    th_l, p_l, g_l = (torch.where(ul, th, tree.th_l), torch.where(ul, p, tree.p_l),
                      torch.where(ul, g, tree.g_l))
    dth = th_r - th_l
    turning_full = ((torch.sum(dth * (inv_mass * p_l), dim=-1) < 0)
                    | (torch.sum(dth * (inv_mass * p_r), dim=-1) < 0))
    new = _Tree(torch.where(ok, tree.depth + 1, tree.depth), th_l, p_l, g_l, th_r, p_r, g_r,
                prop, logw, tree.acc_sum + acc, tree.n_acc + nacc, tree.diverged | div,
                ~ok | turning_full)
    # a chain that was already done keeps its tree
    return _Tree(*(torch.where(active if x.dim() == 1 else active[:, None], x, old)
                   for x, old in zip(new, tree)))


def _tree_result(tree: _Tree) -> tuple:
    """(proposal, accept statistic, (depth, leapfrog steps, diverged))."""
    accept = tree.acc_sum / torch.clamp_min(tree.n_acc, 1.0)
    return tree.prop, accept, (tree.depth, tree.n_acc, tree.diverged.long())


def _leaves(leaf, t: int):
    return leaf[:, 2 ** t - 1: 2 ** (t + 1) - 1]


def _nuts_transition(draws, logprob_and_grad, theta0, eps, inv_mass, max_depth: int,
                     div_thresh: float):
    """One NUTS draw of C chains, eagerly. ``draws`` = (z (C, d), right (C,
    T), swap (C, T), leaf (C, 2^T - 1)); theta0, inv_mass (C, d); eps (C,).
    Returns (theta', accept statistic, (depth, n_leapfrog, diverged))."""
    z, right, swap, leaf = draws
    tree, H0 = _tree_init(logprob_and_grad, theta0, z, inv_mass)
    for t in range(max_depth):
        tree = _doubling(logprob_and_grad, tree, H0, t, right[:, t], swap[:, t],
                         _leaves(leaf, t), eps, inv_mass, div_thresh)
        if bool(tree.done.all()):
            break
    return _tree_result(tree)


def _assign(buffers, values) -> None:
    for b, v in zip(buffers, values):
        b.copy_(v)


class _NUTSKernel:
    """The NUTS transition on static buffers: a graph for the draw's start
    (per phase), one per doubling depth (shared by the phases), one for its
    end (per phase, with the adaptive update), a host read of the chains'
    ``done`` between doublings. ``counts`` tallies draws, doublings and
    host reads."""

    def __init__(self, logprob_and_grad, C: int, d: int, cfg, dtype, device):
        self.lpg, self.T, self.div = logprob_and_grad, cfg.max_treedepth, cfg.divergence_threshold
        f = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        b = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
        T = self.T
        self.draws = [NUTSPhaseDraws(f(n, C, d), b(n, C, T), f(n, C, T), f(n, C, 2 ** T - 1))
                      for n in phase_lengths(cfg)]
        self.cur = NUTSPhaseDraws(f(C, d), b(C, T), f(C, T), f(C, 2 ** T - 1))
        long = torch.zeros(C, dtype=torch.long, device=device)
        self.tree = _Tree(long, *(f(C, d) for _ in range(7)), f(C), f(C), f(C), b(C), b(C))
        self.H0 = f(C)
        self.dtype, self.device = dtype, device
        self.counts = collections.Counter()

    def load(self, phases) -> None:
        _load(self.draws, phases)

    def extras(self, n: int) -> tuple:
        C = self.H0.shape[0]
        long = lambda: torch.zeros((n, C), dtype=torch.long, device=self.device)
        return long(), torch.zeros((n, C), dtype=self.dtype, device=self.device), long()

    def summarize(self, extras) -> dict:
        depth, n_leap, div = extras
        return {"mean_treedepth": depth.to(self.dtype).mean(dim=0),
                "max_treedepth": depth.max(dim=0).values if depth.shape[0] else depth.sum(0),
                "mean_leapfrog": n_leap.mean(dim=0), "n_divergent": div.sum(dim=0)}

    def transition(self, st, phase: int) -> None:
        def begin():
            D = self.draws[phase]
            at = lambda x: x.index_select(0, st.i)[0]
            _assign(self.cur, (at(x) for x in D))
            tree, H0 = _tree_init(self.lpg, st.th, self.cur.z, st.inv_mass)
            _assign(self.tree, tree)
            self.H0.copy_(H0)

        def doubling(t):
            cur = self.cur
            _assign(self.tree, _doubling(self.lpg, self.tree, self.H0, t, cur.right[:, t],
                                         cur.swap[:, t], _leaves(cur.leaf, t), st.eps,
                                         st.inv_mass, self.div))

        st.runner.run(("nuts-begin", phase), begin)
        self.counts["draws"] += 1
        for t in range(self.T):
            st.runner.run(("nuts-doubling", t), lambda: doubling(t))
            self.counts["doublings"] += 1
            if t + 1 == self.T:
                break
            self.counts["host_reads"] += 1
            if bool(self.tree.done.all()):
                break
        st.runner.run(("nuts-end", phase), lambda: st.adapt(phase, *_tree_result(self.tree)))


def nuts_sample(key, logprob: Callable, theta0, config: NUTSConfig = NUTSConfig(),
                graph: Optional[bool] = None):
    """One adaptive NUTS chain from theta0 (d,), ``logprob`` mapping (1, d)
    to (1,). ``key``: a generator or a one-chain ``NUTSDraws``. Returns
    ((n_samples, d) draws, stats) with mean_treedepth, max_treedepth,
    mean_leapfrog and n_divergent."""
    theta0 = _as_theta(theta0)
    d = theta0.shape[-1]
    draws = (draw_nuts(key, 1, d, config, theta0.dtype, init=False)
             if isinstance(key, torch.Generator) else key)
    kernel = _NUTSKernel(make_precise_logprob_and_grad(logprob), 1, d, config, theta0.dtype,
                         theta0.device)
    return _squeeze(*adaptive_mcmc(kernel, theta0[None], draws.phases, config, graph))


def run_chains_nuts(key, logprob: Callable, theta0, n_chains: int = 2,
                    config: NUTSConfig = NUTSConfig(), graph: Optional[bool] = None):
    """C NUTS chains from theta0 (d,) jittered per chain (hmc.run_chains's
    scheme). ``key``: a generator or a ``NUTSDraws``."""
    theta0 = _as_theta(theta0)
    d = theta0.shape[-1]
    draws = (draw_nuts(key, n_chains, d, config, theta0.dtype)
             if isinstance(key, torch.Generator) else key)
    kernel = _NUTSKernel(make_precise_logprob_and_grad(logprob), n_chains, d, config,
                         theta0.dtype, theta0.device)
    return adaptive_mcmc(kernel, _chain_inits(theta0, draws), draws.phases, config,
                         graph)


def make_weighted_nuts(log_joint: Callable):
    """NUTS chains over a weighted posterior with (Z, w) as arguments
    (``make_weighted_hmc``'s pattern): ``chains(key, Z, w, theta0, n_chains,
    config, graph=None)`` -> ((C, n, d) draws, per-chain stats). Its
    ``runner`` holds the cached runs (their kernels' ``counts``)."""
    runner = _WeightedRunner(log_joint, _NUTSKernel, draw_nuts)

    def chains(key, Z, w, theta0, n_chains: int = 2, config: NUTSConfig = NUTSConfig(),
               graph=None):
        return runner(key, Z, w, theta0, n_chains, config, graph, init=True)

    chains.runner = runner
    return chains


_LOGREG_NUTS = None


def run_chains_weighted_logreg_nuts(key, Z, w, theta0, n_chains: int = 2,
                                    config: NUTSConfig = NUTSConfig(), graph=None):
    """Multi-chain weighted-logreg NUTS: the sampler family the reference
    evaluates with (Stan NUTS on the weighted logistic program)."""
    global _LOGREG_NUTS
    if _LOGREG_NUTS is None:
        from ..models import logreg

        _LOGREG_NUTS = make_weighted_nuts(logreg.log_joint)
    return _LOGREG_NUTS(key, Z, w, theta0, n_chains, config, graph)
