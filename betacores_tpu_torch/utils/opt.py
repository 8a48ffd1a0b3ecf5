"""Projected Adam and the learning-rate schedule (counterpart of
betacores_tpu/utils/opt.py).

``nn_adam`` is the reference's update, step for step:

    m1 <- b1*m1 + (1-b1)*g
    m2 <- b2*m2 + (1-b2)*g^2
    x  <- x - lr_i * m1hat / (eps + sqrt(m2hat))        (bias-corrected)
    x  <- max(x, 0) on the non-negatively-constrained coordinates

as a Python loop in place of ``lax.scan``. The reference hands each step a
PRNG key; here the step index takes its place, and pre-drawn per-step
inputs come in through ``xs``. The incremental build's K1 route runs the
same update inside its fused step (ops/kernels.py), with the bias
corrections of ``adam_bias_corrections``; its composed route runs
``adam_update`` on static buffers (coresets/incremental.py), so that the
pass can be replayed as a CUDA graph (utils/graphs.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def step_schedule(i0: float, n_steps: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cuda") -> torch.Tensor:
    """The reference's default learning-rate schedule lr_i = i0 / (1 + i)."""
    return i0 / (1.0 + torch.arange(n_steps, dtype=dtype, device=device))


def adam_bias_corrections(n_steps: int, dtype: torch.dtype,
                          device: torch.device | str = "cuda",
                          b1: float = 0.9, b2: float = 0.999) -> torch.Tensor:
    """(n_steps, 2) [1-b1^t, 1-b2^t] for t = 1..n_steps in ``dtype``.

    The reference raises b (a Python float taken in the working dtype) to
    the power t in the working dtype. In float32 it rounds like libm's
    powf, and torch's float32 pow rounds differently in a few steps, so
    the powers are formed on the host in float64 from the float32 b and
    rounded once: this reproduces the reference's values bit for bit for
    t < 2958 (at t = 2958 and 3606 the two round 0.999^t apart by one
    ulp). In float64 the powers are float64 powers of the Python float."""
    t = np.arange(1, n_steps + 1, dtype=np.float64)
    if dtype == torch.float64:
        bc = [1.0 - np.float64(b) ** t for b in (b1, b2)]
    else:
        bc = [np.float32(1.0) - (np.float64(np.float32(b)) ** t).astype(np.float32)
              for b in (b1, b2)]
    return torch.from_numpy(np.stack(bc, axis=1)).to(dtype=dtype, device=device)


def adam_update(x, m1, m2, g, lr, bc1, bc2, nn_mask=None, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """(x', m1', m2') of one projected-Adam update with step size ``lr``
    and bias corrections ``bc1``, ``bc2`` (tensors that broadcast against
    x), as new tensors."""
    g = g.to(x.dtype)
    m1 = b1 * m1 + (1.0 - b1) * g
    m2 = b2 * m2 + (1.0 - b2) * g * g
    x = x - lr * (m1 / bc1) / (eps + torch.sqrt(m2 / bc2))
    x = torch.clamp_min(x, 0.0) if nn_mask is None else torch.where(
        nn_mask, torch.clamp_min(x, 0.0), x)
    return x, m1, m2


def nn_adam(x0: torch.Tensor, grad_fn: Callable, aux0, step_sizes: torch.Tensor,
            nn_mask: Optional[torch.Tensor] = None, b1: float = 0.9,
            b2: float = 0.999, eps: float = 1e-8,
            xs: Optional[Sequence[torch.Tensor]] = None,
            bias_corrections: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, object]:
    """Projected Adam over len(step_sizes) steps; returns (x, aux).

    ``grad_fn(x, aux, i) -> (g, aux)``, or ``grad_fn(x, aux, i, xs_i)``
    when ``xs`` (a sequence of tensors with leading dimension n_steps) is
    given, with xs_i the tuple of step i's slices. ``i`` is the host step
    index. ``aux`` threads state (e.g. the Laplace mode) from step to step.
    ``nn_mask`` selects the coordinates clipped to >= 0 (None: all).
    ``bias_corrections`` is ``adam_bias_corrections`` of this schedule when
    the caller keeps it (forming it copies from the host, which a caller
    with many passes does once)."""
    n_steps = step_sizes.shape[0]
    bc = bias_corrections
    if bc is None:
        bc = adam_bias_corrections(n_steps, x0.dtype, x0.device, b1, b2)
    lr = step_sizes.to(x0.dtype)
    x, aux = x0, aux0
    m1 = torch.zeros_like(x0)
    m2 = torch.zeros_like(x0)
    for i in range(n_steps):
        if xs is None:
            g, aux = grad_fn(x, aux, i)
        else:
            g, aux = grad_fn(x, aux, i, tuple(t[i] for t in xs))
        x, m1, m2 = adam_update(x, m1, m2, g, lr[i], bc[i, 0], bc[i, 1], nn_mask,
                                b1, b2, eps)
    return x, aux
