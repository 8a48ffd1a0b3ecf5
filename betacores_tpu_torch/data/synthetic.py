"""Synthetic dataset generators (counterpart of betacores_tpu/data/synthetic.py).

Generators draw from an explicit ``torch.Generator`` on its device. Logistic
regression labels use the reference's {-1, +1} convention with rows
Z = y * X; multiclass rows are [X, y] with the class index as a float.
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


def gen_synthetic_multiclass(generator: torch.Generator, n: int, d: int = 4,
                             n_classes: int = 3, spread: float = 2.0,
                             dtype: torch.dtype = torch.float32):
    """K-class softmax synthetic: class parameters th_k ~ spread * N(0, I),
    X ~ N(0, I), labels drawn from the softmax model by the Gumbel-max
    trick. Returns (X, y, Z = [X, y]) with y float class indices in the
    last column (models/multiclass.py row convention)."""
    dev = generator.device
    Th = spread * torch.randn((n_classes, d), generator=generator, dtype=dtype, device=dev)
    X = torch.randn((n, d), generator=generator, dtype=dtype, device=dev)
    u = torch.rand((n, n_classes), generator=generator, dtype=dtype, device=dev)
    y = torch.argmax(X @ Th.T - torch.log(-torch.log(u)), dim=1).to(dtype)
    return X, y, torch.cat([X, y[:, None]], dim=1)
