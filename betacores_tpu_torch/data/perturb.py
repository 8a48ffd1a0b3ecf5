"""Data corruption (counterpart of betacores_tpu/data/perturb.py).

``perturb_logreg`` corrupts rows either unstructured (feature noise on half
the columns of one random row subset, and label flips on another) or
structured (rows replaced by draws of an adversarial logistic model).
``flip_labels`` is the label-flip contamination of the multiclass driver
(examples/multiclass.py).
"""

from __future__ import annotations

from typing import Tuple

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
