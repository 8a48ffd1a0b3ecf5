"""Sampling baselines (counterpart of betacores_tpu/snnls/sampling.py).

Importance sampling with p_n proportional to ||A_n|| (uniform for
``UniformSampling``); after the draws the weights are
w = (counts / total) / p. The result depends only on the multiset of
draws, so a build makes all its draws at once with ``torch.multinomial``
and folds them into the counts with one masked bincount. The draw and the
fold are separate functions, so the tests can fold the JAX package's own
draws. Monotone-error checking is off, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.prng import KeySequence
from .base import as_problem, optimize


def sampling_draws(generator: torch.Generator, ps: torch.Tensor, cap: int) -> torch.Tensor:
    """``cap`` iid column indices drawn with probabilities ``ps``."""
    return torch.multinomial(ps, int(cap), replacement=True, generator=generator)


def sampling_fold(ps: torch.Tensor, counts: torch.Tensor, draws: torch.Tensor, itrs: int):
    """Counts the first ``itrs`` of ``draws`` into ``counts``; returns
    (counts, w) with w = (counts / sum) / ps."""
    mask = (torch.arange(draws.shape[0], device=ps.device) < itrs).to(ps.dtype)
    counts = counts + torch.bincount(draws.to(ps.device), weights=mask,
                                     minlength=ps.shape[0]).to(ps.dtype)
    return counts, (counts / torch.sum(counts)) / ps


def sampling_build(generator: torch.Generator, ps: torch.Tensor, counts: torch.Tensor,
                   itrs: int, cap: int | None = None):
    """Draws ``cap`` (default ``itrs``) indices and counts the first
    ``itrs``: (counts, w)."""
    draws = sampling_draws(generator, ps, itrs if cap is None else cap)
    return sampling_fold(ps, counts, draws, itrs)


def _round_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class ImportanceSampling:
    """The reference's interface, with an explicit seed. ``A`` as in
    ``SparseNNLS``: a tensor keeps its device, anything else goes to
    ``device`` (None: the card)."""

    check_error_monotone = False

    def __init__(self, A, b, seed: int = 0, device=None):
        self.A, self.b = as_problem(A, b, device)
        self.keys = KeySequence(seed, self.A.device)
        self.ps = self._probs()
        self.reset()

    def _probs(self) -> torch.Tensor:
        ps = torch.sqrt(torch.sum(self.A * self.A, dim=0))
        total = torch.sum(ps)
        n = self.A.shape[1]
        return torch.where(total > 0, ps / total, torch.ones_like(ps) / n)

    def _draw(self, cap: int) -> torch.Tensor:
        """One build's draws: ``cap`` indices from the next generator of
        this instance's key sequence."""
        return sampling_draws(self.keys(), self.ps, cap)

    def reset(self) -> None:
        self.counts = torch.zeros(self.A.shape[1], dtype=self.A.dtype, device=self.A.device)
        self.w = torch.zeros_like(self.counts)
        self.reached_numeric_limit = False

    def size(self) -> int:
        return int((self.w > 0).sum())

    def weights(self) -> np.ndarray:
        return self.w.cpu().numpy().copy()

    def error(self) -> float:
        return float(torch.linalg.norm(self.A @ self.w - self.b))

    def build(self, itrs: int) -> None:
        # a power-of-two draw buffer, as the reference's (which compiles one
        # program per capacity); its first itrs draws count
        self.counts, self.w = sampling_fold(self.ps, self.counts,
                                            self._draw(_round_pow2(itrs)), int(itrs))

    def optimize(self) -> None:
        self.w, rolled_back = optimize(self.A, self.b, self.w, min(self.A.shape))
        if bool(rolled_back):
            self.reached_numeric_limit = True


class UniformSampling(ImportanceSampling):
    def _probs(self) -> torch.Tensor:
        n = self.A.shape[1]
        return torch.ones(n, dtype=self.A.dtype, device=self.A.device) / n
