"""Bayesian K-class softmax regression (examples/multiclass.py's experiment),
as the benchmark needs it.

Rows are z = [x, y] with the class index y stored as a float in the last
column; the parameter is a packed theta of K d values (row-major (K, d))
with an N(0, I) prior, and log p(y | x, th) = x . th_y - logsumexp_k x . th_k.
The plain pieces import nothing of the program; ``port_model`` and
``port_sampler`` import it inside the call.

The generator is a copy of ``betacores_tpu_torch/data/synthetic.py::
gen_synthetic_multiclass`` and ``data/perturb.py::flip_labels``, kept here
so that a change to the program's generators cannot move the benchmark's
inputs.
"""

from __future__ import annotations

import torch

from ..reference import log_prior

NAME = "multiclass"
# rows the reference projects at once (its (n, S, K) intermediates in float64)
BLOCK_ROWS = 1 << 17
# the program routes a projection of at least this many rows to its
# projection kernel K2 (ops/kernels.py::FUSED_MIN_ROWS); the launch plan
# below follows that rule, and the K2 reader checks the trace against it
K2_MIN_ROWS = 8192


def theta_dim(cfg: dict) -> int:
    return int(cfg["n_classes"]) * int(cfg["d"])


def row_dim(cfg: dict) -> int:
    return int(cfg["d"]) + 1


def make_data(gen: torch.Generator, cfg: dict) -> torch.Tensor:
    """The (N, d + 1) rows [x, y] from ``gen`` (on its device): class
    parameters th_k ~ spread N(0, I), x ~ N(0, I), labels from the softmax
    model by the Gumbel-max trick; then int(N f_rate) distinct rows get the
    label (y + randint(1, K)) % K, so every flipped label is wrong."""
    n, d, K = int(cfg["n_rows"]), int(cfg["d"]), int(cfg["n_classes"])
    dev, dt = gen.device, torch.float32
    Th = float(cfg["spread"]) * torch.randn((K, d), generator=gen, dtype=dt, device=dev)
    X = torch.randn((n, d), generator=gen, dtype=dt, device=dev)
    u = torch.rand((n, K), generator=gen, dtype=dt, device=dev)
    y = torch.argmax(X @ Th.T - torch.log(-torch.log(u)), dim=1).to(dt)
    Z = torch.cat([X, y[:, None]], dim=1)
    bad = torch.randperm(n, generator=gen, device=dev)[:int(n * float(cfg["f_rate"]))]
    shift = torch.randint(1, K, (bad.shape[0],), generator=gen, device=dev)
    Z[bad, -1] = torch.remainder(Z[bad, -1] + shift.to(dt), K)
    return Z


# --- the reference's model ---------------------------------------------------


class Model:
    """The reference's functions of one class count K."""

    def __init__(self, n_classes: int):
        self.K = n_classes

    def _logits(self, x, th):
        """(..., n, K) logits for one packed theta (K d,) or a batch (C, K d)."""
        Th = th.reshape(*th.shape[:-1], self.K, x.shape[1])
        return torch.matmul(x, Th.transpose(-1, -2))

    def log_joint(self, z, th, w):
        x, y = z[:, :-1], z[:, -1].to(torch.int64)
        lp = torch.log_softmax(self._logits(x, th), dim=-1)
        ll = torch.gather(lp, -1, y.expand(*lp.shape[:-1])[..., None])[..., 0]
        return (w * ll).sum(-1) + log_prior(th)

    def grad(self, z, th, w):
        x, y = z[:, :-1], z[:, -1].to(torch.int64)
        p = torch.softmax(self._logits(x, th), dim=-1)
        coef = torch.nn.functional.one_hot(y, self.K).to(p.dtype) - p
        return -th + ((w[:, None] * coef).T @ x).reshape(-1)

    def hess(self, z, th, w):
        """-I - sum_n w_n (diag(p_n) - p_n p_n^T) (x) x_n x_n^T, as its block
        diagonal less the outer product of the rows p_n (x) x_n."""
        x = z[:, :-1]
        n, d = x.shape
        p = torch.softmax(self._logits(x, th), dim=-1)
        blocks = torch.einsum("nk,nd,ne->kde", w[:, None] * p, x, x)
        B = (p[:, :, None] * x[:, None, :]).reshape(n, self.K * d)
        H = torch.block_diag(*blocks) - B.T @ (w[:, None] * B)
        return -torch.eye(self.K * d, dtype=th.dtype, device=th.device) - H

    def beta_likelihood(self, z, th, beta):
        """(n, S) uncentred β-likelihood: (β+1)/β p_y^β - sum_k p_k^(β+1)."""
        x, y = z[:, :-1], z[:, -1].to(torch.int64)
        n, d, S = x.shape[0], x.shape[1], th.shape[0]
        logits = (x @ th.reshape(S * self.K, d).T).reshape(n, S, self.K)
        lp = torch.log_softmax(logits, dim=-1)
        lp_y = torch.gather(lp, 2, y[:, None, None].expand(n, S, 1))[:, :, 0]
        mass = torch.exp(torch.logsumexp((1.0 + beta) * lp, dim=2))
        return (beta + 1.0) / beta * torch.exp(beta * lp_y) - mass


def reference_model(cfg: dict) -> Model:
    return Model(int(cfg["n_classes"]))


# --- the system under test ---------------------------------------------------


def port_model(cfg: dict):
    from betacores_tpu_torch.models import multiclass
    return multiclass.bundle(int(cfg["n_classes"]))


def port_sampler(cfg: dict):
    from betacores_tpu_torch.inference import multiclass_laplace_sampler
    return multiclass_laplace_sampler(int(cfg["n_classes"]), n_newton=int(cfg["n_newton"]))


# --- operation counts ----------------------------------------------------------


def fit_flops(n: int, K: int, d: int, n_newton: int) -> int:
    """Float operations of one Laplace fit over n weighted rows at the
    configured iteration count: n_newton + 1 gradient, Hessian and
    factorisation evaluations, n_newton line searches over 8 candidates,
    and the first log joint."""
    p = K * d
    grad_ = 4 * n * K * d + 7 * n * K + p
    hess_ = 2 * n * K * d + 4 * n * K + 3 * n * K * K + 2 * n * K * K * d * d + p * p
    factor = p ** 3 // 3 + 4 * p * p + 2 * p
    search = 8 * (2 * n * K * d + 5 * n * K + 2 * n + 2 * p)
    first = 2 * n * K * d + 5 * n * K + 2 * n + 2 * p
    return (n_newton + 1) * (grad_ + hess_ + factor) + n_newton * search + first


def project_flops(n: int, S: int, K: int, d: int) -> int:
    """A centred β-likelihood projection of n rows under S samples: per
    value K (2 d + 7) + 6 (chip_smoke.py::mc_bound's count)."""
    return n * S * (K * (2 * d + 7) + 6)


def selection_flops(cfg: dict, route: dict, m_before: int, m: int) -> int:
    """Float operations one selection needs with m_before live buffer rows
    in its select and m in its refinement (as the logistic family's)."""
    K, d, S, N = (int(cfg["n_classes"]), int(cfg["d"]), int(cfg["projection_dim"]),
                  int(cfg["n_rows"]))
    nn, p = int(cfg["n_newton"]), K * d
    n_sel = N if route["n_select"] is None else route["n_select"]
    sample = S * p * p + S * p
    sel = (fit_flops(m_before, K, d, nn) + sample + project_flops(n_sel + m_before, S, K, d)
           + n_sel * S + 2 * m_before * S + 5 * n_sel * S + 3 * n_sel + 5 * m_before * S)
    if route["groups"]:
        sel += N * S
    n_opt = N if route["n_opt"] is None else route["n_opt"]
    step = (fit_flops(m, K, d, nn) + sample + project_flops(n_opt + m, S, K, d)
            + n_opt * S + 2 * m * S + 2 * m * S + m + 12 * m)
    return sel + route["opt_itrs"] * step


def k2_launch_rows(cfg: dict, route: dict) -> list:
    """The row counts of the K2 launches of one selection, by the program's
    routing rule (a block of at least K2_MIN_ROWS rows): the select projects
    its candidate rows and the buffer (as one block while that stays below
    the rule's size), and each refinement step its rows and the buffer."""
    N, M = int(cfg["n_rows"]), int(route["buffer_slots"])

    def block(n):
        if n + M < K2_MIN_ROWS:            # projected with the buffer, plainly
            return []
        return [r for r in (n, M) if r >= K2_MIN_ROWS]

    n_sel = N if route["n_select"] is None or route["groups"] else route["n_select"]
    n_opt = N if route["n_opt"] is None else route["n_opt"]
    sel = [r for r in (N, M) if r >= K2_MIN_ROWS] if route["n_select"] is None else block(n_sel)
    step = [r for r in (N, M) if r >= K2_MIN_ROWS] if route["n_opt"] is None else block(n_opt)
    return sel + route["opt_itrs"] * step


def k2_bound_ms(cfg: dict, rows: int, peaks) -> float:
    return peaks.mc_bound(rows, int(cfg["projection_dim"]), int(cfg["n_classes"]),
                          int(cfg["d"]), True)["bound_ms"]
