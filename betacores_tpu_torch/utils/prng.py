"""Per-instance random streams (the port's form of
betacores_tpu/utils/prng.py::KeySequence).

Where the reference splits a JAX key per call, ``KeySequence(seed, device)``
returns on each call a fresh ``torch.Generator`` on ``device``, seeded from
a host stream rooted at ``seed``: the same seed gives the same sequence of
generators, hence the same draws, and drawing from one generator never
moves the next one. Seeding happens on the host, so a call costs no device
round trip.
"""

from __future__ import annotations

import numpy as np
import torch


class KeySequence:
    def __init__(self, seed: int = 0, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self._host = np.random.default_rng(seed)

    def next(self) -> torch.Generator:
        seed = int(self._host.integers(0, 2**63 - 1))
        return torch.Generator(device=self.device).manual_seed(seed)

    def __call__(self) -> torch.Generator:
        return self.next()
