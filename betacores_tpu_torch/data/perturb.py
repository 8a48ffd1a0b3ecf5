"""Data corruption (counterpart of betacores_tpu/data/perturb.py).

``perturb_logreg`` corrupts rows either unstructured (feature noise on half
the columns of one random row subset, and label flips on another) or
structured (rows replaced by draws of an adversarial logistic model).
``flip_labels`` is the label-flip contamination of the multiclass driver
(examples/multiclass.py). ``perturb_regression`` and ``perturb_groups``
corrupt regression rows, point by point or whole groups at a time (the
neural-linear example, examples/zellner_neural_linear.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from .synthetic import gen_synthetic_logreg


def _last_draw(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows,) the last draw of ``idx`` that hit each row, or -1."""
    last = torch.full((n_rows,), -1, dtype=torch.int64, device=idx.device)
    return last.scatter_reduce_(0, idx, torch.arange(idx.shape[0], device=idx.device),
                                "amax")


def perturb_logreg(generator: torch.Generator, X: torch.Tensor, y: torch.Tensor,
                   noise_x: Tuple[float, float] = (0.0, 5.0), f_rate: float = 0.1,
                   structured: bool = False, mean_val: float = 0.1,
                   std_val: float = 1.0, theta_val: float = -1.0):
    """Corrupt a fraction ``f_rate`` of rows, ``int(N f_rate)`` drawn with
    replacement. Unstructured: replace D//2 random feature columns of those
    rows with N(noise_x) noise, and flip the labels of as many rows drawn
    independently. Structured: replace those rows and their labels with
    draws of ``gen_synthetic_logreg`` under the adversarial model
    (``mean_val``, ``std_val``, theta = ``theta_val`` * 1). Returns
    (X, y, Z = y * X, outlier_idcs) with the sorted distinct corrupted
    rows. X and y are not modified in place. A row drawn more than once
    keeps its last draw, on every device: the result follows from the
    generator's seed alone (an indexed write over repeated indices would
    leave the winner to the card's scheduling)."""
    N, D = X.shape
    o = int(N * f_rate)
    dev = generator.device
    if o == 0:
        return X, y, y[:, None] * X, torch.zeros(0, dtype=torch.int64, device=dev)
    idxx = torch.randint(0, N, (o,), generator=generator, device=dev)
    last = _last_draw(idxx, N)
    hit = last >= 0
    if structured:
        Xa, ya, _ = gen_synthetic_logreg(generator, o, d=D, mean_val=mean_val,
                                         std_val=std_val, theta_val=theta_val,
                                         dtype=X.dtype)
        X = torch.where(hit[:, None], Xa[last.clamp_min(0)], X)
        y = torch.where(hit, ya[last.clamp_min(0)], y)
        return X, y, y[:, None] * X, torch.unique(idxx)
    idxy = torch.randint(0, N, (o,), generator=generator, device=dev)
    cols = torch.randperm(D, generator=generator, device=dev)[:D // 2]
    noise = noise_x[0] + noise_x[1] * torch.randn((o, D // 2), generator=generator,
                                                  dtype=X.dtype, device=dev)
    X = X.clone()
    X[:, cols] = torch.where(hit[:, None], noise[last.clamp_min(0)], X[:, cols])
    y = y.clone()
    y[idxy] = -y[idxy]
    out_idx = torch.unique(torch.cat([idxx, idxy]))
    return X, y, y[:, None] * X, out_idx


def flip_labels(generator: torch.Generator, Z: torch.Tensor, n_classes: int,
                f_rate: float):
    """Label-flip contamination of multiclass rows [x, y]: ``int(N f_rate)``
    distinct rows, drawn without replacement, get the class
    (y + randint(1, K)) % K, so every flipped label is wrong. Returns
    (Z with the flipped labels, the flipped rows). Z is not modified in
    place."""
    N = Z.shape[0]
    dev = generator.device
    bad = torch.randperm(N, generator=generator, device=dev)[:int(N * f_rate)]
    shift = torch.randint(1, n_classes, (bad.shape[0],), generator=generator, device=dev)
    Z = Z.clone()
    Z[bad, -1] = torch.remainder(Z[bad, -1] + shift.to(Z.dtype), n_classes)
    return Z, bad


class RegressionCorruption(NamedTuple):
    """The draws of ``perturb_regression``: ``rows`` (o,) drawn with
    replacement, the D//2 (at least 1) distinct feature ``cols``, the
    (o, len(cols)) feature ``noise`` and the (o,) responses ``y_new``."""

    rows: torch.Tensor
    cols: torch.Tensor
    noise: torch.Tensor
    y_new: torch.Tensor


def draw_regression_corruption(generator: torch.Generator, N: int, D: int,
                               noise_x: Tuple[float, float] = (1.0, 10.0),
                               f_rate: float = 0.1,
                               y_noise: Tuple[float, float] = (0.0, 5.0),
                               dtype: torch.dtype = torch.float32) -> RegressionCorruption:
    """The draws of ``perturb_regression`` on (N, D) features, on the
    generator's device."""
    o, dev = int(N * f_rate), generator.device
    rows = torch.randint(0, N, (o,), generator=generator, device=dev)
    cols = torch.randperm(D, generator=generator, device=dev)[:max(D // 2, 1)]
    noise = noise_x[0] + noise_x[1] * torch.randn((o, cols.shape[0]), generator=generator,
                                                  dtype=dtype, device=dev)
    y_new = y_noise[0] + y_noise[1] * torch.randn((o,), generator=generator, dtype=dtype,
                                                  device=dev)
    return RegressionCorruption(rows, cols, noise, y_new)


def apply_regression_corruption(X: torch.Tensor, y: torch.Tensor,
                                draws: RegressionCorruption):
    """(X, y (N, 1)) with the drawn rows' chosen features and responses
    replaced; a row drawn more than once keeps its last draw. X and y are
    not modified in place."""
    if draws.rows.shape[0] == 0:
        return X, y
    last = _last_draw(draws.rows, X.shape[0])
    hit, src = last >= 0, last.clamp_min(0)
    X = X.clone()
    X[:, draws.cols] = torch.where(hit[:, None], draws.noise[src].to(X.dtype), X[:, draws.cols])
    y = torch.where(hit[:, None], draws.y_new[src, None].to(y.dtype), y)
    return X, y


def perturb_regression(generator: torch.Generator, X: torch.Tensor, y: torch.Tensor,
                       noise_x: Tuple[float, float] = (1.0, 10.0), f_rate: float = 0.1,
                       y_noise: Tuple[float, float] = (0.0, 5.0)):
    """Point-level regression corruption: ``int(N f_rate)`` rows drawn with
    replacement get N(noise_x) noise on D//2 random feature columns and an
    N(y_noise) response. Returns (X, y); y is (N, 1)."""
    N, D = X.shape
    draws = draw_regression_corruption(generator, N, D, noise_x, f_rate, y_noise, X.dtype)
    return apply_regression_corruption(X, y, draws)


def perturb_groups(seed: Union[int, np.random.Generator], X, y, groups,
                   noise_x: Tuple[float, float] = (1.0, 1.0), f_rate: float = 0.1,
                   corrupt_frac: float = 0.7, y_noise: Tuple[float, float] = (10.0, 0.5)):
    """Group-targeted corruption, on the host: ``int(G f_rate)`` groups
    are picked (with replacement) and ``corrupt_frac`` of each picked
    group's members get N(noise_x) noise on D//2 random feature columns
    and an N(y_noise) response. ``seed`` is an integer or a
    ``np.random.Generator``; ``groups`` is a list of index lists. Returns
    new NumPy arrays (X, y)."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(int(seed))
    X = np.array(X, copy=True)
    y = np.array(y, copy=True)
    N, D = X.shape
    lg = len(groups)
    o = int(lg * f_rate)
    if o == 0:
        return X, y
    picked = rng.choice(lg, size=o)
    rows = np.concatenate([
        rng.choice(np.asarray(groups[g]), size=int(len(groups[g]) * corrupt_frac), replace=False)
        for g in picked
    ]).astype(int)
    cols = rng.choice(D, max(D // 2, 1), replace=False)
    for c in cols:
        X[rows, c] = rng.normal(noise_x[0], noise_x[1], size=len(rows))
    y[rows] = rng.normal(y_noise[0], y_noise[1], size=(len(rows),) + y.shape[1:])
    return X, y
