"""Optimizer helpers (counterpart of betacores_tpu/utils/opt.py).

Only the learning-rate schedule is ported so far: the incremental build's
projected-Adam update runs inside the fused step (ops/kernels.py), with the
constants of ``nn_adam`` (b1=0.9, b2=0.999, eps=1e-8).
"""

from __future__ import annotations

import torch


def step_schedule(i0: float, n_steps: int, dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """The reference's default learning-rate schedule lr_i = i0 / (1 + i)."""
    return i0 / (1.0 + torch.arange(n_steps, dtype=dtype, device=device))
