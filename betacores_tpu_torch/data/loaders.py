"""Dataset loading and preprocessing on the host (counterpart of
betacores_tpu/data/loaders.py).

Every function is NumPy on the host and gives the same arrays (and lists,
and errors) as the reference for the same files and inputs: the npz
datasets of the reference's experiments (arrays ``X``, ``y`` and optional
``Xt``, ``yt``; labels in {-1, +1}, or {0, 1} remapped) with their
train/test split and covariate whitening, the group pickles, the
neural-linear example's standardisation and random groups, and the UCI
regression sets read from local files. The port's own copy: this package
never imports the JAX package.

One deliberate difference: the data roots are ``$BETACORES_DATA`` and the
repository's ``data/`` only; the reference also searches a fixed directory
outside the repository.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np


def load_npz(path: str, ttr: float = 0.2):
    """(X, Y, Xt, Yt) in float64 from an (X, y[, Xt, yt]) npz. Without test
    arrays the last max(1, int(ttr * N)) rows are the test set (the
    reference model_lr.py:6-18, whose int(ttr * N) = 0 would hand every row
    to the test set)."""
    data = np.load(path, allow_pickle=True)
    X = np.asarray(data["X"], dtype=np.float64)
    Y = np.asarray(data["y"], dtype=np.float64).reshape(-1)
    has_test = (
        "Xt" in data and "yt" in data
        and np.asarray(data["Xt"]).size > 1 and np.asarray(data["yt"]).size > 1
    )
    if has_test:
        Xt = np.asarray(data["Xt"], dtype=np.float64)
        Yt = np.asarray(data["yt"], dtype=np.float64).reshape(-1)
    else:
        n_test = max(1, int(ttr * X.shape[0]))
        n_train = X.shape[0] - n_test
        if n_train < 1:
            raise ValueError(
                f"load_npz: {X.shape[0]} rows cannot satisfy a {ttr} test "
                f"split with at least one training row")
        X, Y, Xt, Yt = X[:n_train], Y[:n_train], X[n_train:], Y[n_train:]
    # remap {0,1} labels to {-1,+1}
    if set(np.unique(Y)) <= {0.0, 1.0}:
        Y = 2.0 * Y - 1.0
        Yt = 2.0 * Yt - 1.0
    return X, Y, Xt, Yt


def std_cov(X: np.ndarray, Y: np.ndarray, mean_: Optional[np.ndarray] = None,
            cov_: Optional[np.ndarray] = None):
    """Whiten the covariates by the Cholesky factor of their covariance; the
    last column (intercept) is untouched (reference model_lr.py:20-30).
    Returns (X, Y, Z=y*X, mean, cov); pass (mean, cov) back in to transform
    test data consistently."""
    X = np.array(X, copy=True)
    if mean_ is None:
        mean_ = X[:, :-1].mean(axis=0)
        cov_ = np.cov(X[:, :-1], rowvar=False) + 1e-12 * np.eye(X.shape[1] - 1)
    L = np.linalg.cholesky(np.atleast_2d(cov_))
    X[:, :-1] = np.linalg.solve(L, (X[:, :-1] - mean_).T).T
    Z = Y[:, None] * X
    return X, Y, Z, mean_, cov_


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


def add_intercept(X: np.ndarray) -> np.ndarray:
    return np.hstack([X, np.ones((X.shape[0], 1), dtype=X.dtype)])


def load_groups_pickle(path: str) -> Tuple[List[List[int]], list]:
    """Load a demographic-groups pickle ``(groups, demos)`` as produced by
    the preprocessing scripts (reference preproc_adult.py:20-31)."""
    with open(path, "rb") as f:
        groups, demos = pickle.load(f)
    return [list(map(int, g)) for g in groups], demos


def make_random_groups(rng: np.random.Generator, N: int, group_size: int) -> List[List[int]]:
    """A random partition of range(N) into consecutive slices of one
    permutation, ``group_size`` rows each (the last may be shorter)."""
    perm = rng.permutation(N)
    return [perm[i: i + group_size].tolist() for i in range(0, N, group_size)]


def _data_roots():
    """Search order: $BETACORES_DATA, then the repository's ``data/``."""
    repo_data = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data")
    return (os.environ.get("BETACORES_DATA", ""), repo_data)


def reference_dataset_path(name: str) -> Optional[str]:
    """The first ``<root>/<name>.npz`` over the data roots, or None."""
    for root in _data_roots():
        if root:
            p = os.path.join(root, f"{name}.npz")
            if os.path.exists(p):
                return p
    return None


def groups_pickle_path(dataset: str, dataset_path: Optional[str] = None) -> Optional[str]:
    """Resolve a ``vq_groups_sensemake_<dataset>.pk`` group artifact
    (reference preproc_adult.py:20-48 format), or None.

    When ``dataset_path`` (the resolved npz) is given, ONLY its own
    directory is searched: group indices encode that preprocessing run's
    row ordering, and a pickle from a different root would silently index
    the wrong rows of a re-preprocessed npz."""
    if dataset_path is not None:
        p = os.path.join(os.path.dirname(dataset_path),
                         f"vq_groups_sensemake_{dataset}.pk")
        return p if os.path.exists(p) else None
    for root in _data_roots():
        if root:
            p = os.path.join(root, f"vq_groups_sensemake_{dataset}.pk")
            if os.path.exists(p):
                return p
    return None


def load_uci_regression(name: str, data_dir: Optional[str] = None):
    """The reference neural-linear experiment's UCI regression loaders
    (spec: reference examples/common/model_neurlinr.py:6-35), read from
    local files. Returns ``(X, Y)`` with ``Y`` of shape (N, 1).

    - ``boston``:  ``boston.csv`` (header row, MEDV target last) or the
      classic whitespace ``housing.data`` (506 x 14, target last).
    - ``news``:    ``news.csv`` — drop every column whose name contains
      ``_is_``, drop the first data row and first two remaining columns
      (url, timedelta), min-max scale features; target = last column.
    - ``year``:    ``year.txt`` comma-delimited; X = all but last column,
      Y = last.
    - ``prices2018``: ``prices2018.npy``; the same last-column-target split.

    Searches ``data_dir`` if given, else the data roots."""
    roots = [data_dir] if data_dir else [r for r in _data_roots() if r]

    def _find(*fnames):
        for root in roots:
            for fn in fnames:
                p = os.path.join(root, fn)
                if os.path.exists(p):
                    return p
        raise FileNotFoundError(
            f"{name}: none of {fnames} found under {roots}; put the file in "
            f"$BETACORES_DATA or data/ to enable this dataset")

    if name == "boston":
        p = _find("boston.csv", "housing.data")
        data = (np.genfromtxt(p, delimiter=",", skip_header=1)
                if p.endswith(".csv") else np.genfromtxt(p))
    elif name == "news":
        p = _find("news.csv", "OnlineNewsPopularity.csv")
        with open(p) as f:
            header = [c.strip() for c in f.readline().split(",")]
        keep = [i for i, c in enumerate(header) if "_is_" not in c]
        data = np.genfromtxt(p, delimiter=",", skip_header=1)[:, keep]
        data = data[1:, 2:]  # the reference drops the first data row + url/timedelta
        X, Y = data[:, :-1], data[:, -1:]
        lo, hi = X.min(axis=0), X.max(axis=0)
        span = np.where(np.isclose(hi - lo, 0.0), 1.0, hi - lo)
        return (X - lo) / span, Y
    elif name == "year":
        data = np.genfromtxt(_find("year.txt", "YearPredictionMSD.txt"), delimiter=",")
    elif name == "prices2018":
        data = np.load(_find("prices2018.npy"))
    else:
        raise ValueError(f"Unsupported UCI regression dataset: {name!r}")
    return data[:, :-1], data[:, -1:]
