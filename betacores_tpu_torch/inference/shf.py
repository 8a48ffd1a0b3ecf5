"""Sparse Hamiltonian flows: coreset-parameterized normalizing flows
(counterpart of betacores_tpu/inference/shf.py; arXiv:2203.05723).

    q0(theta, rho) = N(mu0, diag(exp(2 logs0))) x N(0, I)
    T = R_K . H_L . ... . R_1 . H_L          (K blocks)
    H_L : L leapfrog steps on U_w(theta) = -log prior - sum_m w_m ll_m
    R_k : rho <- exp(a_k) rho + b_k          (log|det J| = sum a_k)

trained by Adam on the full-data ELBO, the log joint estimated on uniform
minibatches with weights N/B; the coreset (w >= 0, optionally the points)
shapes only the dynamics, so a flow step costs O(M). The model enters
through ``log_joint(Z, theta, w)``, theta (n, d) -> (n,).

The ELBO differentiates through the leapfrog's gradients of U_w, so the
flow takes them with ``create_graph=True`` and the training step runs a
double backward. On a CUDA device that step is captured once as a CUDA
graph and replayed (``utils/graphs.py``), the step index and the step's
draws on the device; elsewhere, or with ``graph=False``, it runs eagerly.
Each leapfrog step reuses the gradient at its start from the step before
(the reference evaluates it twice, to the same value). The optimizer is
``utils/opt.py::adam_update``, optax's Adam (the same moments, bias
corrections and epsilon) with w projected to w >= 0 after each update, from
a fresh state at every training call. Every training call's draws are made up front
(``SHFDraws``, ``draw_shf``), or injected: the tests feed the JAX
package's. ``make_sharded_shf_trainer`` splits the ELBO's lanes over a
mesh's ranks.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.graphs import PassRunner, resolve_graph
from ..utils.opt import adam_bias_corrections, adam_update

_LOG2PI = math.log(2.0 * math.pi)


class SHFConfig(NamedTuple):
    n_blocks: int = 8          # K quasi-refreshment blocks
    n_leapfrog: int = 10       # L leapfrog steps per block
    init_step: float = 0.05    # initial leapfrog step size
    train_pts: bool = False    # also optimize pseudo-point locations
    n_mc: int = 8              # q0 draws per ELBO estimate
    n_batch: int = 256         # data minibatch for the full log-joint term
    learning_rate: float = 1e-2


class SHFParams(NamedTuple):
    w: torch.Tensor        # (M,) coreset weights (kept >= 0 by projection)
    pts: torch.Tensor      # (M, D) coreset points (trained iff train_pts)
    log_eps: torch.Tensor  # (K,) per-block leapfrog log step sizes
    a: torch.Tensor        # (K, d) refreshment log-scales
    b: torch.Tensor        # (K, d) refreshment shifts
    mu0: torch.Tensor      # (d,) initial-distribution mean
    logs0: torch.Tensor    # (d,) initial-distribution log-stddevs


class SHFDraws(NamedTuple):
    """A training call's randomness over T steps."""

    z_th: torch.Tensor     # (T, n_mc, d) normals of theta0
    z_rho: torch.Tensor    # (T, n_mc, d) normals of rho0
    idx: torch.Tensor      # (T, n_batch) int64 minibatch rows


def init_shf_params(pts0: torch.Tensor, theta_dim: int, N: int,
                    config: SHFConfig = SHFConfig()) -> SHFParams:
    """From a size-M pseudo-coreset (weights N/M), deterministically."""
    M, K = pts0.shape[0], config.n_blocks
    kw = dict(dtype=pts0.dtype, device=pts0.device)
    return SHFParams(w=torch.full((M,), N / M, **kw), pts=pts0,
                     log_eps=torch.full((K,), math.log(config.init_step), **kw),
                     a=torch.zeros((K, theta_dim), **kw), b=torch.zeros((K, theta_dim), **kw),
                     mu0=torch.zeros(theta_dim, **kw), logs0=torch.zeros(theta_dim, **kw))


def _grad_U(params: SHFParams, log_joint: Callable, th, create_graph: bool):
    """Gradient of U_w = -log_joint(pts, th, w) at each row of th (n, d);
    with ``create_graph`` it stays differentiable in the params and th."""
    with torch.enable_grad():
        x = th if create_graph else th.detach().requires_grad_(True)
        U = -log_joint(params.pts, x, params.w).sum()
        (g,) = torch.autograd.grad(U, x, create_graph=create_graph)
    return g


def _flow_forward(params: SHFParams, log_joint: Callable, theta0, rho0,
                  config: SHFConfig, create_graph: bool = False):
    """Push (theta0, rho0) (n, d) through the flow. Returns (theta_T, rho_T,
    log_det) with log_det = sum_k 1^T a_k (leapfrog preserves volume)."""
    th, rho = theta0, rho0
    g = _grad_U(params, log_joint, th, create_graph)
    for k in range(params.log_eps.shape[0]):
        eps = torch.exp(params.log_eps[k])
        for _ in range(config.n_leapfrog):
            rho = rho - 0.5 * eps * g
            th = th + eps * rho
            g = _grad_U(params, log_joint, th, create_graph)
            rho = rho - 0.5 * eps * g
        rho = torch.exp(params.a[k]) * rho + params.b[k]
    return th, rho, torch.sum(params.a)


def _std_normal_logpdf(x):
    return -0.5 * x.shape[-1] * _LOG2PI - 0.5 * torch.sum(x * x, dim=-1)


def _diag_normal_logpdf(x, mu, logs):
    z = (x - mu) / torch.exp(logs)
    return -0.5 * x.shape[-1] * _LOG2PI - torch.sum(logs) - 0.5 * torch.sum(z * z, dim=-1)


def _push(params: SHFParams, log_joint: Callable, z_th, z_rho, config: SHFConfig,
          create_graph: bool):
    """(theta_T, rho_T, log q) of the flow from q0's normals."""
    theta0 = params.mu0 + torch.exp(params.logs0) * z_th
    log_q0 = (_diag_normal_logpdf(theta0, params.mu0, params.logs0)
              + _std_normal_logpdf(z_rho))
    th, rho, log_det = _flow_forward(params, log_joint, theta0, z_rho, config, create_graph)
    return th, rho, log_q0 - log_det


def shf_sample(key, params: SHFParams, log_joint: Callable, n: int,
               config: SHFConfig = SHFConfig()):
    """(n, d) i.i.d. samples of the flow, their pushed momenta, and log
    q(theta, rho) at the pushed pair. ``key``: a generator on the params'
    device, or the normals (z_th, z_rho), each (n, d)."""
    d, kw = params.mu0.shape[0], dict(dtype=params.mu0.dtype, device=params.mu0.device)
    if isinstance(key, torch.Generator):
        z_th = torch.randn((n, d), generator=key, **kw)
        z_rho = torch.randn((n, d), generator=key, **kw)
    else:
        z_th, z_rho = (torch.as_tensor(z, **kw) for z in key)
    with torch.no_grad():
        return _push(params, log_joint, z_th, z_rho, config, create_graph=False)


def draw_shf(generator: torch.Generator, n_steps: int, N: int, d: int,
             config: SHFConfig = SHFConfig(), dtype: torch.dtype = torch.float32) -> SHFDraws:
    """A training call's draws, up front, on the generator's device."""
    kw = dict(generator=generator, dtype=dtype, device=generator.device)
    shape = (n_steps, config.n_mc, d)
    return SHFDraws(torch.randn(shape, **kw), torch.randn(shape, **kw),
                    torch.randint(0, N, (n_steps, config.n_batch), generator=generator,
                                  device=generator.device))


class _Trainer:
    """The static buffers and graph of one training call's length: the
    params (leaves that autograd differentiates), Adam's moments, the step
    index, the draws and the ELBO trace."""

    def __init__(self, data, log_joint, config: SHFConfig, params: SHFParams, n_steps: int,
                 graph: bool):
        self.data, self.log_joint, self.cfg = data, log_joint, config
        dev = data.device
        self.params = SHFParams(*(torch.zeros_like(x, device=dev).requires_grad_(True)
                                  for x in params))
        self.m = [torch.zeros_like(x) for x in self.params]
        self.v = [torch.zeros_like(x) for x in self.params]
        # Adam projects w to w >= 0 and leaves every other parameter free
        self.nn_mask = [None] + [torch.zeros_like(x, dtype=torch.bool) for x in self.params[1:]]
        d = params.mu0.shape[0]
        self.draws = SHFDraws(torch.zeros((n_steps, config.n_mc, d), dtype=data.dtype, device=dev),
                              torch.zeros((n_steps, config.n_mc, d), dtype=data.dtype, device=dev),
                              torch.zeros((n_steps, config.n_batch), dtype=torch.long, device=dev))
        self.bc = adam_bias_corrections(n_steps, data.dtype, dev)
        self.trace = torch.zeros(n_steps, dtype=data.dtype, device=dev)
        self.i = torch.zeros(1, dtype=torch.long, device=dev)
        self.wb = torch.full((config.n_batch,), data.shape[0] / config.n_batch,
                             dtype=data.dtype, device=dev)
        self.runner = PassRunner(graph)
        self.n_steps = n_steps

    def _terms(self):
        """The ELBO's terms log p + log N(rho) - log q of the step's lanes,
        differentiable in the params."""
        cfg, P = self.cfg, self.params
        at = lambda x: x.index_select(0, self.i)[0]
        th, rho, log_q = _push(P, self.log_joint, at(self.draws.z_th), at(self.draws.z_rho),
                               cfg, create_graph=True)
        batch = self.data.index_select(0, at(self.draws.idx))
        return self.log_joint(batch, th, self.wb) + _std_normal_logpdf(rho) - log_q

    def _elbo_and_grads(self):
        """(the ELBO estimate, its negative's gradient in each param)."""
        with torch.enable_grad():
            elbo = torch.mean(self._terms())
            grads = torch.autograd.grad(-elbo, list(self.params))
        return elbo, grads

    def _step(self) -> None:
        cfg, P = self.cfg, self.params
        elbo, grads = self._elbo_and_grads()
        bc = self.bc.index_select(0, self.i)[0]
        with torch.no_grad():
            for k, (p, m, v, g, mask) in enumerate(zip(P, self.m, self.v, grads, self.nn_mask)):
                if k == 1 and not cfg.train_pts:
                    g = torch.zeros_like(g)
                p_new, m_new, v_new = adam_update(p, m, v, g, cfg.learning_rate, bc[0], bc[1],
                                                  nn_mask=mask)
                p.copy_(p_new)
                m.copy_(m_new)
                v.copy_(v_new)
            self.trace.index_copy_(0, self.i, elbo.detach()[None])
            self.i.add_(1)

    def run(self, params: SHFParams, draws: SHFDraws) -> tuple:
        with torch.no_grad():
            for buf, x in zip(self.params, params):
                buf.copy_(x)
            for x in self.m + self.v:
                x.zero_()
            for buf, x in zip(self.draws, draws):
                if tuple(buf.shape) != tuple(x.shape):
                    raise ValueError(f"draws of shape {tuple(x.shape)}, want {tuple(buf.shape)}")
                buf.copy_(x)
            self.i.zero_()
        for _ in range(self.n_steps):
            self.runner.run("step", self._step)
        return SHFParams(*(x.detach().clone() for x in self.params)), self.trace.clone()


def make_shf_trainer(data: torch.Tensor, log_joint: Callable, config: SHFConfig = SHFConfig(),
                     graph: Optional[bool] = None):
    """``train(key, params, n_steps) -> (params, elbo_trace)``: ``n_steps``
    Adam steps from a fresh optimizer state, maximizing the full-data ELBO.
    ``key``: a generator on the data's device, or an ``SHFDraws``. A step
    zeroes the gradient of the points unless ``config.train_pts`` and
    projects w to w >= 0 after the update."""
    graph = resolve_graph(graph, data.device)
    trainers: dict = {}

    def train(key, params: SHFParams, n_steps: int):
        sig = (n_steps, tuple(tuple(x.shape) for x in params))
        if sig not in trainers:
            trainers[sig] = _Trainer(data, log_joint, config, params, n_steps, graph)
        draws = (draw_shf(key, n_steps, data.shape[0], params.mu0.shape[0], config, data.dtype)
                 if isinstance(key, torch.Generator) else key)
        return trainers[sig].run(params, draws)

    return train


class _ShardedTrainer(_Trainer):
    """A ``_Trainer`` of this rank's n_mc / P lanes and minibatch: the
    gradient of its terms' share of the ELBO (their mean times n_loc / n_mc,
    their sum over n_mc) takes one psum over ``data`` then one over ``samp``
    (the ELBO rides in the same two); Adam and the projection are
    replicated. In a world of one the share is the mean times 1.0, so the
    step computes what ``_Trainer``'s does, bit for bit."""

    def __init__(self, mesh, n_mc: int, *args):
        super().__init__(*args)
        self.mesh, self.n_mc = mesh, n_mc
        self.runner.calls = mesh.calls

    def _elbo_and_grads(self):
        from ..parallel.mesh import DATA_AXIS, SAMP_AXIS

        with torch.enable_grad():
            terms = self._terms()
            elbo = torch.mean(terms) * (terms.shape[0] / self.n_mc)
            grads = torch.autograd.grad(-elbo, list(self.params))
        flat = torch.cat([g.reshape(-1) for g in grads] + [elbo.detach().reshape(1)])
        flat = self.mesh.psum(self.mesh.psum(flat, DATA_AXIS), SAMP_AXIS)
        parts = torch.split(flat, [g.numel() for g in grads] + [1])
        return parts[-1][0], [p.reshape(g.shape) for p, g in zip(parts, grads)]


def _draw_sharded_shf(generator: torch.Generator, n_steps: int, N: int, d: int, mesh,
                     config: SHFConfig = SHFConfig(), dtype: torch.dtype = torch.float32
                     ) -> SHFDraws:
    """This rank's draws of a sharded training call: every rank draws the
    whole world's (``draw_shf`` of n_mc lanes and P minibatches of
    ``n_batch`` rows a step, from a generator seeded alike) and keeps its
    own n_mc / P lanes and its own minibatch, each rank's differing from
    every other's; in a world of one they are ``draw_shf``'s."""
    n_ranks = mesh.n_data * mesh.n_samp
    n_loc, B = config.n_mc // n_ranks, config.n_batch
    every = draw_shf(generator, n_steps, N, d, config._replace(n_batch=B * n_ranks), dtype)
    r = mesh.rank
    return SHFDraws(every.z_th[:, r * n_loc:(r + 1) * n_loc],
                    every.z_rho[:, r * n_loc:(r + 1) * n_loc], every.idx[:, r * B:(r + 1) * B])


def make_sharded_shf_trainer(data: torch.Tensor, log_joint: Callable, mesh,
                             config: SHFConfig = SHFConfig(), graph: Optional[bool] = None):
    """``make_shf_trainer`` with the ELBO's Monte-Carlo lanes split over
    every rank of ``mesh`` (the reference's lane sharding): each rank
    pushes its n_mc / P flow lanes and its own B-row minibatch through the
    flow, and one psum over ``data`` then over ``samp`` of the gradient of
    its terms' sum over n_mc gives every rank the replicated-mean
    gradient; the params, Adam, the w >= 0 projection and the ``train_pts``
    switch are replicated, the ELBO trace psum'd. ``data`` is whole on
    every rank, moved to the mesh's device. ``train(key, params, n_steps)
    -> (params, elbo_trace)``: ``key`` a generator seeded alike on every
    rank (``_draw_sharded_shf``), or this rank's ``SHFDraws`` of its n_mc / P
    lanes and minibatch. ``config.n_mc`` must divide over the P ranks.
    ``graph`` as ``make_shf_trainer``'s: a captured step holds its two
    all-reduces."""
    from ..parallel.mesh import require_axes

    n_data, n_samp = require_axes(mesh)
    n_ranks = n_data * n_samp
    if config.n_mc % n_ranks:
        raise ValueError(f"n_mc {config.n_mc} must divide over {n_ranks} ranks")
    data = data.to(mesh.device)
    graph = resolve_graph(graph, mesh.device)
    cfg_loc = config._replace(n_mc=config.n_mc // n_ranks)
    trainers: dict = {}

    def train(key, params: SHFParams, n_steps: int):
        params = SHFParams(*(x.to(mesh.device) for x in params))
        sig = (n_steps, tuple(tuple(x.shape) for x in params))
        if sig not in trainers:
            trainers[sig] = _ShardedTrainer(mesh, config.n_mc, data, log_joint, cfg_loc,
                                            params, n_steps, graph)
        draws = (_draw_sharded_shf(key, n_steps, data.shape[0], params.mu0.shape[0], mesh,
                                  config, data.dtype)
                 if isinstance(key, torch.Generator) else key)
        return trainers[sig].run(params, draws)

    return train


def beta_log_joint(model, beta: float, log_prior: Callable = None) -> Callable:
    """The robust beta-divergence target with the ``log_joint(Z, theta, w)``
    signature: log prior + sum_n w_n f_beta(z_n, theta), from a bundle's
    ``beta_likelihood``; theta (d,) or (n, d). Default prior: N(0, I)."""
    blik = model.beta_likelihood

    def log_joint(Z, th, w):
        th2 = th.reshape(-1, th.shape[-1])
        f = blik(Z, th2, beta)                          # (N, n)
        lp = (-0.5 * th2.shape[-1] * _LOG2PI - 0.5 * torch.sum(th2 * th2, dim=-1)
              if log_prior is None else log_prior(th2))
        return (torch.sum(w[:, None] * f, dim=0) + lp).reshape(th.shape[:-1])

    return log_joint


def gaussian_log_joint(Siginv, mu0=None, Sig0inv=None) -> Callable:
    """The weighted Gaussian-mean log joint (known covariance) with the
    ``log_joint(Z, theta, w)`` signature; theta (d,) or (n, d)."""

    def log_joint(Z, th, w):
        d = th.shape[-1]
        m0 = torch.zeros(d, dtype=th.dtype, device=th.device) if mu0 is None else mu0
        S0 = torch.eye(d, dtype=th.dtype, device=th.device) if Sig0inv is None else Sig0inv
        diff = Z - th[..., None, :]                     # (..., N, d)
        ll = -0.5 * torch.sum((diff @ Siginv) * diff, dim=-1)
        dp = th - m0
        return torch.sum(w * ll, dim=-1) - 0.5 * torch.sum((dp @ S0) * dp, dim=-1)

    return log_joint
