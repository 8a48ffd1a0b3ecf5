"""Non-negative least squares on a support (counterpart of
betacores_tpu/snnls/nnls.py).

An accelerated projected-gradient (FISTA) solve restricted to a support,
in place of the reference's scipy ``nnls``: the support's columns are
gathered into a fixed-width (D, K) block, so no shape depends on the data
and nothing is read on the host. FISTA with monotone restart on a strictly
convex quadratic reaches the active-set solution geometrically; the tests
hold it to a Lawson-Hanson oracle.
"""

from __future__ import annotations

import math

import torch


def nnls_fista(G: torch.Tensor, c: torch.Tensor, valid: torch.Tensor,
               n_iters: int = 400) -> torch.Tensor:
    """min_w 1/2 w'Gw - c'w  s.t. w >= 0, restricted to the ``valid``
    slots. G: (K, K) PSD Gram, c: (K,), valid: (K,) bool."""
    # a Lipschitz bound from 16 power iterations on G
    v = torch.ones_like(c) / math.sqrt(c.shape[0])
    for _ in range(16):
        v = G @ v
        v = v / (torch.linalg.norm(v) + 1e-300)
    inv_L = 1.0 / (torch.clamp_min(v @ (G @ v), 1e-300) * 1.01)
    validf = valid.to(c.dtype)
    w = y = torch.zeros_like(c)
    t = torch.ones((), dtype=c.dtype, device=c.device)
    for _ in range(n_iters):
        g = G @ y - c
        w_new = torch.clamp_min(y - inv_L * g, 0.0) * validf
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y_new = w_new + (t - 1.0) / t_new * (w_new - w)
        # monotone restart: momentum pointing uphill resets to a plain step
        restart = torch.dot(g, w_new - w) > 0
        y = torch.where(restart, w_new, y_new)
        t = torch.where(restart, 1.0, t_new)
        w = w_new
    return w


def support_slots(support: torch.Tensor, K: int):
    """(idx, valid): the first K columns flagged in ``support`` in
    ascending order, padded with column N - 1, and which of the K slots
    hold a flagged column. A fixed shape, built with a cumsum and a
    scatter (no ``nonzero``, so no host read)."""
    N = support.shape[0]
    pos = torch.cumsum(support.to(torch.int64), 0) - 1
    # every column not kept writes into the discard slot K
    slot = torch.where(support & (pos < K), pos, K)
    idx = torch.full((K + 1,), N - 1, dtype=torch.int64, device=support.device)
    idx.scatter_(0, slot, torch.arange(N, device=support.device))
    valid = torch.arange(K, device=support.device) < support.sum()
    return idx[:K], valid


def nnls_on_support(A: torch.Tensor, b: torch.Tensor, support: torch.Tensor,
                    max_support: int, n_iters: int = 400) -> torch.Tensor:
    """NNLS over the columns flagged in ``support`` (bool (N,)), scattered
    back into an (N,) vector with zeros elsewhere. ``max_support`` is the
    block width K (>= the true support size)."""
    N = A.shape[1]
    idx, valid = support_slots(support, min(max_support, N))
    # the Gram and the right-hand side are summed in float64 and rounded
    # once: the restricted problem is ill-conditioned, and a float32
    # matrix-vector product's sums put enough error into As^T b to move the
    # solution off the reference's (LAR's columns departed from float64's
    # within 50 iterations, where the JAX package's float32 LAR held)
    acc = torch.promote_types(A.dtype, torch.float64)
    As = (A[:, idx] * valid.to(A.dtype)[None, :]).to(acc)
    ws = nnls_fista((As.T @ As).to(A.dtype), (As.T @ b.to(acc)).to(A.dtype), valid,
                    n_iters=n_iters)
    # an add, not a set: a padding slot points at column N - 1, which may
    # also be a real support column, and adds 0 to its weight
    w = torch.zeros(N, dtype=A.dtype, device=A.device)
    return w.index_add_(0, idx, torch.where(valid, ws, 0.0))
