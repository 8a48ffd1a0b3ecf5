"""Group-level data valuation: Monte-Carlo (distributional) Shapley and
truncated Monte-Carlo Shapley (counterpart of
betacores_tpu/valuation/shapley.py).

Each Monte-Carlo round draws a permutation of the groups and scans its
prefixes; the value of a prefix (test accuracy of the posterior fitted to
the prefix's rows, at most ``group_cap`` rows per group) is taken at each
one, and each group collects its marginal contribution, averaged over the
rounds that reached it.

The value function fits a Newton-Laplace posterior on ALL (N, d) rows with
a {0, 1} weight vector, so every fit has the same shapes; prefix
membership is arithmetic (row i is in prefix j iff its group's rank in
the permutation is <= j); the per-group cap is a top-k over uniforms and a
scatter-max. Where the reference maps a compiled body over the
permutations and scans the prefixes, the port loops over both on the host,
one fit at a time, with no host read but the truncation test of TMC, one
per prefix: a truncated prefix skips its fit. The draws (the permutation,
the cap's uniforms and each prefix's posterior noise) are made apart from
the compute, from a ``torch.Generator`` or replayed
(``PermutationDraws``). Everything runs on the device of the data.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..inference.laplace import newton_laplace, sample_laplace_from_noise
from ..models import logreg
from ..ops.projection import Groups


def capped_member_mask(draw, groups: Groups, cap: Optional[int], n_data: int) -> torch.Tensor:
    """(N,) bool mask keeping at most ``cap`` uniformly-chosen members of
    each group. ``draw`` is a ``torch.Generator`` on the groups' device or
    the (G, L_max) uniforms themselves."""
    members = groups.members
    if cap is None or cap >= groups.max_size:
        return torch.ones(n_data, dtype=torch.bool, device=members.device)
    valid = members >= 0
    u = draw if isinstance(draw, torch.Tensor) else torch.rand(
        members.shape, generator=draw, dtype=torch.float64, device=members.device)
    u = torch.where(valid, u.to(members.device), -torch.inf)
    kth = torch.topk(u, cap, dim=1).values[:, -1]          # cap-th largest per group
    keep = (u >= kth[:, None]) & valid
    flat = members.reshape(-1)
    # padding members point at row N - 1 with keep = 0: a max never turns it on
    mask = torch.zeros(n_data, dtype=torch.int32, device=members.device)
    mask.scatter_reduce_(0, torch.where(flat >= 0, flat, n_data - 1),
                         keep.reshape(-1).to(torch.int32), "amax")
    return mask.bool()


class LaplaceAccuracy:
    """The value of a subset of rows: the test accuracy of the
    Newton-Laplace posterior of logistic regression fitted with weights w
    (a {0, 1} vector over every row), from ``n_samples`` draws
    theta = mu + L^-T z. ``value(z, w, Z, Xt, Yt)`` takes the draws' noise
    z (n_samples, d), made by ``draw(generator, Z, Xt, Yt)``."""

    def __init__(self, n_samples: int = 256, n_newton: int = 10):
        self.n_samples, self.n_newton = n_samples, n_newton

    def draw(self, generator: torch.Generator, Z, Xt, Yt) -> torch.Tensor:
        return torch.randn((self.n_samples, Z.shape[1]), generator=generator, dtype=Z.dtype,
                           device=Z.device)

    def __call__(self, z, w, Z, Xt, Yt) -> torch.Tensor:
        w = w.to(torch.promote_types(w.dtype, Z.dtype))
        lap = newton_laplace(lambda th: logreg.log_joint(Z, th, w),
                             lambda th: logreg.grad_th_log_joint(Z, th, w),
                             lambda th: logreg.hess_th_log_joint(Z, th, w),
                             torch.zeros(Z.shape[1], dtype=Z.dtype, device=Z.device),
                             n_iters=self.n_newton)
        return logreg.compute_accuracy(Xt, Yt, sample_laplace_from_noise(lap, z.to(Z.device)))


def logreg_laplace_value_fn(n_samples: int = 256, n_newton: int = 10) -> LaplaceAccuracy:
    """The posterior-predictive test accuracy of logistic regression under
    the Laplace approximation (the reference fits each subset with Stan);
    the data are call-time operands, ``value_args=(Z, Xt, Yt)``."""
    return LaplaceAccuracy(n_samples, n_newton)


class PermutationDraws(NamedTuple):
    """The draws of one Monte-Carlo round: the permutation (G,), the cap's
    uniforms (G, L_max) or None without a cap, and the value function's
    noise for each prefix (n_prefixes, ...)."""

    perm: torch.Tensor
    cap_u: Optional[torch.Tensor]
    noise: torch.Tensor


class _PermutationRunner:
    """What the two estimators share: the draws of a round and the
    membership of a prefix."""

    def __init__(self, gid, groups: Groups, value_fn, group_cap, mesh, value_args,
                 n_prefixes: int):
        if mesh is not None:
            raise NotImplementedError("Shapley permutations sharded over a mesh are not "
                                      "ported yet (ROADMAP Queue A item 12)")
        self.G, self.N = groups.n_groups, gid.shape[0]
        self.groups, self.value_fn, self.cap = groups, value_fn, group_cap
        self.vargs, self.n_prefixes = tuple(value_args), n_prefixes
        dev = groups.members.device
        self.gid = gid.to(dev)
        self.in_group = self.gid < self.G
        self.gid_c = self.gid.clamp_max(self.G - 1)
        self.capped = group_cap is not None and group_cap < groups.max_size

    def draws(self, generator: torch.Generator) -> PermutationDraws:
        """One round's draws from ``generator``: the permutation, the cap's
        uniforms, then each prefix's noise."""
        dev = self.groups.members.device
        perm = torch.randperm(self.G, generator=generator, device=dev)
        cap_u = (torch.rand(self.groups.members.shape, generator=generator,
                            dtype=torch.float64, device=dev) if self.capped else None)
        noise = torch.stack([self.value_fn.draw(generator, *self.vargs)
                             for _ in range(self.n_prefixes)])
        return PermutationDraws(perm, cap_u, noise)

    def rounds(self, draws, T: int):
        """(perm, rank of each row's group, capped member mask, noise) of
        each of T rounds; ``draws`` is a generator or a sequence of T
        ``PermutationDraws``."""
        dev = self.groups.members.device
        for t in range(T):
            d = self.draws(draws) if isinstance(draws, torch.Generator) else draws[t]
            perm = d.perm.to(dev)
            pos = torch.empty(self.G, dtype=torch.int64, device=dev)
            pos.scatter_(0, perm, torch.arange(self.G, device=dev))
            cmask = capped_member_mask(d.cap_u, self.groups, self.cap if self.capped else None,
                                       self.N)
            yield perm, pos[self.gid_c], cmask & self.in_group, d.noise

    def value(self, noise_j, rank, member, j: int):
        w = ((rank <= j) & member).to(torch.float32)
        return self.value_fn(noise_j, w, *self.vargs)


def make_dshapley(gid: torch.Tensor, groups: Groups, value_fn: Callable, max_groups: int,
                  group_cap: Optional[int] = None, prior_value: float = 0.5, mesh=None,
                  value_args: Sequence = ()) -> Callable:
    """``dshapley(draws, T) -> phis (G,)``: the first ``max_groups``
    prefixes of T permutations. ``prior_value`` is the value of the empty
    prefix (accuracy 0.5 under the prior). ``draws``: a
    ``torch.Generator`` or T ``PermutationDraws`` (``dshapley.draws(gen)``
    makes one round's)."""
    mg = min(max_groups, groups.n_groups)
    runner = _PermutationRunner(gid, groups, value_fn, group_cap, mesh, value_args, mg)

    def dshapley(draws, T: int) -> torch.Tensor:
        G, dev = runner.G, groups.members.device
        phis = torch.zeros(G, dtype=torch.float32, device=dev)
        occs = torch.zeros(G, dtype=torch.float32, device=dev)
        for perm, rank, member, noise in runner.rounds(draws, T):
            v_prev = torch.full((), prior_value, dtype=torch.float32, device=dev)
            margs = []
            for j in range(mg):
                v = runner.value(noise[j], rank, member, j).to(torch.float32)
                margs.append(v - v_prev)
                v_prev = v
            phis.index_add_(0, perm[:mg], torch.stack(margs))
            occs.index_add_(0, perm[:mg], torch.ones(mg, dtype=torch.float32, device=dev))
        return torch.where(occs > 0, phis / occs, 0.0)

    dshapley.draws = runner.draws
    return dshapley


def make_tmc_shapley(gid: torch.Tensor, groups: Groups, value_fn: Callable,
                     full_value: float, tol: float = 0.01, group_cap: Optional[int] = None,
                     prior_value: float = 0.5, mesh=None,
                     value_args: Sequence = ()) -> Callable:
    """Truncated Monte-Carlo Shapley (Ghorbani & Zou): ``tmc(draws, T) ->
    phis (G,)`` scans whole permutations, and once a prefix's value is
    within ``tol`` of ``full_value`` the remaining prefixes of that round
    add zero and are not fitted. ``draws`` as ``make_dshapley``'s."""
    runner = _PermutationRunner(gid, groups, value_fn, group_cap, mesh, value_args,
                                groups.n_groups)

    def tmc(draws, T: int) -> torch.Tensor:
        G, dev = runner.G, groups.members.device
        phis = torch.zeros(G, dtype=torch.float32, device=dev)
        occs = torch.zeros(G, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        for perm, rank, member, noise in runner.rounds(draws, T):
            v_prev = torch.full((), prior_value, dtype=torch.float32, device=dev)
            margs, truncated = [], False
            for j in range(G):
                if truncated:
                    margs.append(zero)
                    continue
                v = runner.value(noise[j], rank, member, j).to(torch.float32)
                margs.append(v - v_prev)
                v_prev = v
                # the one host read of a prefix: a truncated round skips its fits
                truncated = bool(torch.abs(full_value - v) < tol)
            phis.index_add_(0, perm, torch.stack(margs))
            occs.index_add_(0, perm, torch.ones(G, dtype=torch.float32, device=dev))
        return torch.where(occs > 0, phis / occs, 0.0)

    tmc.draws = runner.draws
    return tmc
