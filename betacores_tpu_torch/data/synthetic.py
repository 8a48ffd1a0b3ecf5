"""Synthetic dataset generators (counterpart of betacores_tpu/data/synthetic.py).

Generators draw from an explicit ``torch.Generator`` on its device; labels
use the reference's {-1, +1} convention with rows Z = y * X.
"""

from __future__ import annotations

import math

import torch


def gen_synthetic_logreg(generator: torch.Generator, n: int, d: int = 2,
                         mean_val: float = 1.0, std_val: float = 1.0,
                         theta_val: float = 1.0, dtype: torch.dtype = torch.float32):
    """X ~ N(mean_val, std_val I), labels from the logistic model with
    theta = theta_val * 1. Returns (X, y, Z = y * X)."""
    dev = generator.device
    X = mean_val + math.sqrt(std_val) * torch.randn((n, d), generator=generator,
                                                    dtype=dtype, device=dev)
    th = torch.full((d,), theta_val, dtype=dtype, device=dev)
    ps = torch.sigmoid(X @ th)
    u = torch.rand((n,), generator=generator, dtype=dtype, device=dev)
    y = torch.where(u <= ps, 1.0, -1.0).to(dtype)
    return X, y, y[:, None] * X
