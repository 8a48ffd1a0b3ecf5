"""Data corruption (counterpart of betacores_tpu/data/perturb.py).

Only the unstructured branch is ported: feature noise on half the columns
of one random row subset, and label flips on another.
"""

from __future__ import annotations

from typing import Tuple

import torch


def perturb_logreg(generator: torch.Generator, X: torch.Tensor, y: torch.Tensor,
                   noise_x: Tuple[float, float] = (0.0, 5.0), f_rate: float = 0.1,
                   structured: bool = False):
    """Corrupt a fraction ``f_rate`` of rows: replace D//2 random feature
    columns with N(noise_x) noise on ``int(N f_rate)`` rows drawn with
    replacement, and flip the labels of as many rows drawn independently.
    Returns (X, y, Z = y * X, outlier_idcs) with the sorted distinct
    corrupted rows. X and y are not modified in place."""
    if structured:
        raise NotImplementedError("structured corruption is not ported yet")
    N, D = X.shape
    o = int(N * f_rate)
    dev = generator.device
    if o == 0:
        return X, y, y[:, None] * X, torch.zeros(0, dtype=torch.int64, device=dev)
    idxx = torch.randint(0, N, (o,), generator=generator, device=dev)
    idxy = torch.randint(0, N, (o,), generator=generator, device=dev)
    cols = torch.randperm(D, generator=generator, device=dev)[:D // 2]
    noise = noise_x[0] + noise_x[1] * torch.randn((o, D // 2), generator=generator,
                                                  dtype=X.dtype, device=dev)
    X = X.clone()
    X[idxx[:, None], cols[None, :]] = noise
    y = y.clone()
    y[idxy] = -y[idxy]
    out_idx = torch.unique(torch.cat([idxx, idxy]))
    return X, y, y[:, None] * X, out_idx
