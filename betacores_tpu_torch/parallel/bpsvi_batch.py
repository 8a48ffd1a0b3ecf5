"""BPSVI lanes sharded over a mesh (counterpart of
betacores_tpu/parallel/bpsvi_batch.py).

The reference builds the BPSVI coreset of every size in a process pool,
and the JAX package ``vmap``s the lanes (sizes) and shards them over every
device of the mesh. Here the lanes are split over every rank, rank
r = ax_d * n_samp + ax_s taking the r-th contiguous block (the reference's
``P((DATA_AXIS, SAMP_AXIS))``), and each rank runs its lanes one after
another through ``coresets.bpsvi.bpsvi_build_batch`` against the whole
dataset, with no collective until one gather over both axes brings every
lane to every rank. The lane count is padded up to a multiple of the rank
count with dummy size-1 lanes, dropped before returning.

Every rank draws the whole batch's draws from a generator seeded alike
(the true lanes first, in lane order, as ``bpsvi_build_batch`` draws
them, then the dummy lanes'), and keeps its own lanes', so lane i equals
``bpsvi_build_batch``'s lane i bit for bit.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..coresets.bpsvi import BPSVIConfig, bpsvi_build_batch, make_bpsvi_builder
from .mesh import Mesh, gather_lanes, lane_block, require_axes


def make_sharded_bpsvi_batch(data: torch.Tensor, model, sampler, config: BPSVIConfig,
                             mesh: Mesh) -> Callable:
    """``batch(draws, sizes, max_size, aux0) -> (wts, pts, idcs)`` with the
    lanes (sizes) split over every rank of ``mesh`` and ``data`` (N, D)
    whole on every rank, moved to the mesh's device. ``draws``: a
    ``torch.Generator`` on that device (seeded alike on every rank), or one
    ``BPSVIDraws`` per true lane (the dummy lanes reuse the first's).
    Returns (wts (L, max_size), pts (L, max_size, D), idcs (L, max_size)),
    every lane on every rank. On a CUDA device each lane's pass replays as
    CUDA graphs, as ``bpsvi_build_batch``'s do."""
    require_axes(mesh)
    builder = make_bpsvi_builder(data.to(mesh.device), model, sampler, config)

    def batch(draws, sizes: Sequence[int], max_size: int, aux0):
        sizes = [int(s) for s in sizes]
        L = len(sizes)
        n_lanes, lo, per = lane_block(L, mesh)
        sizes_p = sizes + [1] * (n_lanes - L)
        aux0 = aux0.to(mesh.device)
        if isinstance(draws, torch.Generator):
            draws = [builder.draws(draws, max_size, aux0) for _ in sizes_p]
        else:
            draws = list(draws) + [draws[0]] * (n_lanes - L)
        out = bpsvi_build_batch(builder, draws[lo:lo + per], sizes_p[lo:lo + per],
                                max_size, aux0)
        return tuple(gather_lanes(mesh, out, L))

    return batch
