"""Laplace approximation via damped Newton (counterpart of
betacores_tpu/inference/laplace.py).

The reference stops adaptively in a ``lax.while_loop`` once the Newton
decrement lambda^2 = g . (-H)^-1 g falls below ``tol * (1 + |log_joint|)``.
Here the loop runs a fixed ``n_iters`` times and FREEZES its carry once the
done flag is set, so it returns the same mode and factor as the while loop
without a host read of the flag: the build's refinement loop stays free of
device-to-host syncs (and capturable as a CUDA graph). Iterations after
``done`` still execute; their results are discarded by ``torch.where``.

Where -H is not positive definite, ``jnp.linalg.cholesky`` returns NaN in
the factor's lower triangle; ``cholesky_ex`` returns a finite partial
factor and a nonzero ``info``. ``eval_at`` turns that case into the
reference's NaN factor on the device (no host read of ``info``), so the
Newton direction is NaN, every line-search candidate scores -inf and the
step is rejected, as in the reference.

``newton_laplace_diag`` is the diagonal-Hessian variant (the reference's
``graddiag``), a fixed-count loop as the reference's scan is.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from ..models.base import identity

# Backtracking grid: candidate step sizes tried per Newton iteration.
_TS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625, 0.0078125)


@functools.cache
def _nan_lower(d: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(d, d) with NaN on and below the diagonal and 0 above: what
    ``jnp.linalg.cholesky`` returns for a matrix that is not positive
    definite. Made once per size, dtype and device; read-only."""
    return torch.full((d, d), float("nan"), dtype=dtype, device=device).tril()


@functools.cache
def _ts(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The grid ``_TS`` = 2^-k, k = 0..7, made once per dtype and device (a
    host-to-device copy in every refit would synchronise the stream) and
    made on the device by exact halvings, so that a traced program (which
    traces through the cache) holds the same values without a constant."""
    halves = torch.cumprod(torch.full((len(_TS) - 1,), 0.5, dtype=dtype, device=device), 0)
    return torch.cat([torch.ones(1, dtype=dtype, device=device), halves])


class LaplaceApprox(NamedTuple):
    mu: torch.Tensor                              # (d,) mode
    prec_chol: torch.Tensor                       # (d, d) lower chol of -H
    prec_chol_inv: Optional[torch.Tensor] = None  # L^-1, with_inverse only


def newton_laplace(
    log_joint: Callable[[torch.Tensor], torch.Tensor],
    grad: Callable[[torch.Tensor], torch.Tensor],
    hess: Callable[[torch.Tensor], torch.Tensor],
    mu0: torch.Tensor,
    n_iters: int = 8,
    with_inverse: bool = False,
) -> LaplaceApprox:
    """Maximize a concave log-joint by damped Newton with a static
    backtracking grid. ``log_joint`` takes a (d,) point or a (K, d) batch
    of candidates. ``with_inverse=True`` computes the Newton direction
    through the explicit L^-1 and returns it in ``prec_chol_inv``; otherwise
    through two triangular solves (``cho_solve``)."""
    d = mu0.shape[-1]

    def eval_at(mu):
        g = grad(mu)
        H = hess(mu)
        # cholesky_ex: no host check of the info flag (cholesky syncs); a
        # failed factorization becomes the reference's NaN factor
        L, info = torch.linalg.cholesky_ex(-H)
        L = torch.where(info == 0, L, _nan_lower(d, L.dtype, L.device))
        if with_inverse:
            linv = torch.linalg.solve_triangular(L, identity(d, L.dtype, L.device),
                                                 upper=False)
            pg = linv @ g
            p = linv.T @ pg
            lam2 = pg @ pg
        else:
            linv = L  # placeholder so the carry has one structure
            y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
            p = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
            lam2 = g @ p
        return L, linv, p, lam2

    f = log_joint(mu0)
    L, linv, p, lam2 = eval_at(mu0)
    mu = mu0.to(torch.promote_types(mu0.dtype, p.dtype))
    tol = 1e-7 if mu.dtype == torch.float64 else 1e-5
    done = lam2 <= tol * (1.0 + torch.abs(f))
    ts = _ts(mu.dtype, mu.device)

    for _ in range(n_iters):
        cands = mu[None, :] + ts[:, None] * p[None, :]
        vals = log_joint(cands)
        vals = torch.where(torch.isfinite(vals), vals, float("-inf"))
        best = torch.argmax(vals).reshape(1)
        v_best = vals.index_select(0, best)[0]
        improved = v_best > f
        mu_new = torch.where(improved, cands.index_select(0, best)[0], mu)
        f_new = torch.where(improved, v_best, f)
        L_new, linv_new, p_new, lam2 = eval_at(mu_new)
        # a step that does not improve exits: retrying it cannot succeed
        done_new = (lam2 <= tol * (1.0 + torch.abs(f_new))) | ~improved
        mu = torch.where(done, mu, mu_new)
        f = torch.where(done, f, f_new)
        L = torch.where(done, L, L_new)
        linv = torch.where(done, linv, linv_new)
        p = torch.where(done, p, p_new)
        done = done | done_new
    return LaplaceApprox(mu=mu, prec_chol=L,
                         prec_chol_inv=linv if with_inverse else None)


def newton_laplace_diag(
    log_joint: Callable[[torch.Tensor], torch.Tensor],
    grad: Callable[[torch.Tensor], torch.Tensor],
    diag_hess: Callable[[torch.Tensor], torch.Tensor],
    mu0: torch.Tensor,
    n_iters: int = 12,
) -> LaplaceApprox:
    """Diagonal-Hessian Newton (reference ``newton_laplace_diag``): the
    direction g / (-diag_hess), the same 8-point backtracking grid, and the
    covariance diag(1 / -diag_hess) at the mode, as the factor
    diag(sqrt(-diag_hess(mu))). Runs exactly ``n_iters`` iterations with no
    early exit, as the reference's scan does."""
    g = grad(mu0)
    mu = mu0.to(torch.promote_types(mu0.dtype, g.dtype))
    ts = _ts(mu.dtype, mu.device)
    for it in range(n_iters):
        if it:
            g = grad(mu)
        p = g / (-diag_hess(mu))
        cands = mu[None, :] + ts[:, None] * p[None, :]
        vals = log_joint(cands)
        vals = torch.where(torch.isfinite(vals), vals, float("-inf"))
        best = torch.argmax(vals).reshape(1)
        improved = vals.index_select(0, best)[0] > log_joint(mu)
        mu = torch.where(improved, cands.index_select(0, best)[0], mu)
    return LaplaceApprox(mu=mu, prec_chol=torch.diag(torch.sqrt(-diag_hess(mu))))


def sample_laplace_from_noise(lap: LaplaceApprox, z: torch.Tensor) -> torch.Tensor:
    """theta = mu + L^-T z for standard normals z (n, d): covariance
    L^-T L^-1 = (-H)^-1."""
    return lap.mu + torch.linalg.solve_triangular(
        lap.prec_chol.T, z.T, upper=True).T


def sample_laplace(generator: torch.Generator, lap: LaplaceApprox,
                   n_samples: int) -> torch.Tensor:
    """(n, d) draws theta = mu + L^-T z, z ~ N(0, I) drawn from
    ``generator`` (None: the default generator of the fit's device) in the
    fit's dtype: covariance (-H)^-1."""
    z = torch.randn((n_samples, lap.mu.shape[0]), generator=generator, dtype=lap.mu.dtype,
                    device=lap.mu.device)
    return sample_laplace_from_noise(lap, z)
