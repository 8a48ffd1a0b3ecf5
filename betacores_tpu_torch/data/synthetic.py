"""Synthetic dataset generators (counterpart of betacores_tpu/data/synthetic.py).

Generators draw from an explicit ``torch.Generator`` on its device. Logistic
regression labels use the reference's {-1, +1} convention with rows
Z = y * X; multiclass, linear-regression and Poisson rows are [X, y] with
y in the last column.
"""

from __future__ import annotations

import math

import torch

from ..models.logreg import softplus


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


def gen_synthetic_gaussian(generator: torch.Generator, N: int = 5000, d: int = 100,
                           sig_scale: float = 500.0, dtype: torch.dtype = torch.float32):
    """The contaminated-Gaussian experiment's data: X ~ N(0, sig_scale I)
    plus three outlier clusters, +200 shifted (N/50), +150 tight (N/50) and
    10x inflated (N/10). Returns (X_clean, X_corrupted, Sig)."""
    dev = generator.device
    s = math.sqrt(sig_scale)
    randn = lambda n: torch.randn((n, d), generator=generator, dtype=dtype, device=dev)
    X = s * randn(N)
    o1 = 200.0 + math.sqrt(0.5) * s * randn(N // 50)
    o2 = 150.0 + math.sqrt(0.1) * s * randn(N // 50)
    o3 = math.sqrt(10.0) * s * randn(N // 10)
    Xc = torch.cat([X, o1, o2, o3])
    return X, Xc, sig_scale * torch.eye(d, dtype=dtype, device=dev)


def gen_synthetic_linreg(generator: torch.Generator, N: int = 2000, D: int = 40,
                         noise_std: float = 0.1, dtype: torch.dtype = torch.float32):
    """Bayesian linear-regression data: w ~ 10 + N(0, I) over D features and
    an intercept column, y = X w + noise. Returns (X, y (N, 1), w)."""
    dev = generator.device
    d = D + 1
    w = 10.0 + torch.randn((d,), generator=generator, dtype=dtype, device=dev)
    X = torch.randn((N, d), generator=generator, dtype=dtype, device=dev)
    X[:, -1] = 1.0
    y = X @ w + noise_std * torch.randn((N,), generator=generator, dtype=dtype, device=dev)
    return X, y[:, None], w


def gen_synthetic_poisson(generator: torch.Generator, N: int = 2000, d: int = 5,
                          theta_scale: float = 0.5, dtype: torch.dtype = torch.float32):
    """Poisson-regression data: X with an intercept column, rates
    f = softplus(X th), counts y ~ Poisson(f). Returns
    (X, y, Z = [X, y], theta_true)."""
    dev = generator.device
    th = theta_scale * torch.randn((d,), generator=generator, dtype=dtype, device=dev)
    X = torch.randn((N, d), generator=generator, dtype=dtype, device=dev)
    X[:, -1] = 1.0
    y = torch.poisson(softplus(X @ th), generator=generator)
    return X, y, torch.cat([X, y[:, None]], dim=1), th
