"""Projection engine (counterpart of betacores_tpu/ops/projection.py).

The projection of a point z under S posterior samples is the S-vector of
centered (beta-)log-likelihoods v_n = ll(z_n, th_s) - mean_s ll(z_n, th_s).
Group projections use a padded (G, L_max) member-index matrix with -1
padding (``Groups``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


def center(v: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return v - v.mean(dim=dim, keepdim=True)


def _use_fused(model, field: str, n_rows: int) -> bool:
    from .kernels import maybe_fused

    return getattr(model, field, None) is not None and maybe_fused(n_rows)


def project_ll(model, pts, samples):
    """Centered (N, S) log-likelihood projection. Row blocks of at least
    FUSED_MIN_ROWS go to the model's fused projection when it has one."""
    if _use_fused(model, "fused_ll_projection", pts.shape[0]):
        return model.fused_ll_projection(pts, samples)
    return center(model.log_likelihood(pts, samples))


def project_beta(model, pts, samples, beta):
    """Centered (N, S) beta-likelihood projection, routed as ``project_ll``."""
    if _use_fused(model, "fused_beta_projection", pts.shape[0]):
        return model.fused_beta_projection(pts, samples, beta)
    return center(model.beta_likelihood(pts, samples, beta))


def project_ll_with_grad(model, pts, samples):
    """Centred log-likelihood and data-gradient projections, ((N, S),
    (N, S, D)), both centred over the sample axis."""
    lls = center(model.log_likelihood(pts, samples))
    glls = model.grad_z_log_likelihood(pts, samples)
    return lls, glls - glls.mean(dim=1, keepdim=True)


def project_beta_with_grad(model, pts, samples, beta):
    """Centred beta-likelihood projection and its centred d/d(beta), for
    the joint (w, beta) refinement. Always the plain ``beta_likelihood``:
    the fused projections have no beta-gradient."""
    return (center(model.beta_likelihood(pts, samples, beta)),
            center(model.beta_gradient(pts, samples, beta)))


def draw_subsample(generator: Optional[torch.Generator], n_total: int,
                   n_subsample: int, device=None) -> Tuple[torch.Tensor, float]:
    """Uniform with-replacement subsample indices on the generator's device,
    and the importance rescale sum_scaling = N / n. ``generator`` None
    draws from the default generator of ``device``, as an exported program
    does (utils/export.py)."""
    idcs = torch.randint(0, n_total, (n_subsample,), generator=generator,
                         device=device if generator is None else generator.device)
    return idcs, n_total / n_subsample


class Groups(NamedTuple):
    """Group-structured data for batch (group-level) selection.

    members: (G, L_max) int64, row g lists the data indices of group g,
    padded with -1. sizes: (G,) true member counts. ``n_groups`` and
    ``max_size`` come from the shape, so no shape depends on a device read."""

    members: torch.Tensor
    sizes: torch.Tensor

    @staticmethod
    def from_lists(group_lists, device=None) -> "Groups":
        """Groups from lists of member indices, on ``device`` (None: the
        card). Groups must be disjoint: the group reductions and the
        Shapley prefix masks assign each point to one group."""
        from ..utils.device import resolve_device

        G = len(group_lists)
        L = max(len(g) for g in group_lists)
        m = -np.ones((G, L), dtype=np.int64)
        seen = set()
        for i, g in enumerate(group_lists):
            dup = seen.intersection(int(x) for x in g)
            if dup:
                raise ValueError(f"groups must be disjoint; shared points {sorted(dup)[:5]}...")
            seen.update(int(x) for x in g)
            m[i, :len(g)] = np.asarray(g, dtype=np.int64)
        sizes = np.asarray([len(g) for g in group_lists], dtype=np.int64)
        dev = resolve_device(device)
        return Groups(members=torch.from_numpy(m).to(dev), sizes=torch.from_numpy(sizes).to(dev))

    @property
    def n_groups(self) -> int:
        return self.members.shape[0]

    @property
    def max_size(self) -> int:
        return self.members.shape[1]


def project_groups(project_fn, data: torch.Tensor, groups: Groups,
                   group_idcs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(G_sel, S) group projection: a group's vector is the sum of its
    members' projected vectors. ``project_fn`` maps an (n, D) block to its
    centred (n, S) projection; padding slots (-1) add zero."""
    members = groups.members if group_idcs is None else groups.members[group_idcs]
    G, L = members.shape
    flat = members.reshape(-1)
    vecs = project_fn(data[flat.clamp_min(0)])              # (G*L, S)
    mask = (flat >= 0).to(vecs.dtype)[:, None]
    return (vecs * mask).reshape(G, L, -1).sum(dim=1)
