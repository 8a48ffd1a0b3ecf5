"""Host data helpers of the neural-linear example (counterpart of
betacores_tpu/data/loaders.py's ``standardize`` and ``make_random_groups``).

Both are NumPy on the host and give the same arrays and lists as the
reference for the same inputs and ``rng``. The rest of the reference's
loaders (files on disk, the UCI sets) is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np


def standardize(Xtrain, ytrain, *others):
    """Zero-mean unit-variance standardisation fit on the training pair and
    applied to any number of further (X, y) pairs. Returns the standardised
    arrays, then (in_mean, in_std, out_mean, out_std); a zero standard
    deviation is taken as 1."""
    in_mean, in_std = Xtrain.mean(axis=0), Xtrain.std(axis=0)
    in_std = np.where(np.isclose(in_std, 0.0), 1.0, in_std)
    out_mean, out_std = ytrain.mean(axis=0), ytrain.std(axis=0)
    out_std = np.where(np.isclose(out_std, 0.0), 1.0, out_std)
    out = [(Xtrain - in_mean) / in_std, (ytrain - out_mean) / out_std]
    for i in range(0, len(others), 2):
        out.append((others[i] - in_mean) / in_std)
        out.append((others[i + 1] - out_mean) / out_std)
    return (*out, in_mean, in_std, out_mean, out_std)


def make_random_groups(rng: np.random.Generator, N: int, group_size: int) -> List[List[int]]:
    """A random partition of range(N) into consecutive slices of one
    permutation, ``group_size`` rows each (the last may be shorter)."""
    perm = rng.permutation(N)
    return [perm[i: i + group_size].tolist() for i in range(0, N, group_size)]
