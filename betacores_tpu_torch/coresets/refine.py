"""Post-build weight refinement, a quasi-Newton polish (counterpart of
betacores_tpu/coresets/refine.py; after Naik et al., "Fast Bayesian
Coresets via Subsampling and Quasi-Newton Refinement", arXiv:2203.09675).

The builders refine the weights by Monte-Carlo Adam with fresh posterior
samples at every step, so their last iterate carries O(1/sqrt(S)) sampling
noise. The polish freezes ONE large draw of S_big samples from the current
coreset posterior and solves the tangent-space least squares

    min_{w >= 0, supp(w) in the selected slots}  || V_core^T w - v_total ||

(V_core the (M, S_big) coreset projections, v_total the sum of the data's
projections, optionally over a subsample with the N/n rescale) with the
FISTA NNLS of snnls/nnls.py, and keeps the result only if it lowers that
frozen objective.

Meant for clean-data KL builds (SparseVI, Hilbert settings). On
contaminated data, matching the corrupted full-data projection exactly
pulls a beta-divergence build toward the contamination, which the
Monte-Carlo refinement's noise guards against: do not polish those.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.projection import draw_subsample, project_beta, project_ll
from ..snnls.nnls import nnls_on_support
from .state import CoresetState


def refine_weights(draws, data: torch.Tensor, model, sampler: Callable,
                   state: CoresetState, n_samples: int = 500,
                   n_subsample: Optional[int] = None, use_beta: bool = False,
                   nnls_iters: int = 600,
                   data_weights: Optional[torch.Tensor] = None) -> CoresetState:
    """``state`` with its weights re-solved on a frozen projection, on the
    support of its active slots.

    ``draws`` is a ``torch.Generator`` on the data's device, from which the
    sampler draws the S_big samples and then the subsample is drawn, or a
    pair (z (S_big, d), subsample indices or None) replayed through a
    sampler with a noise split, as ``make_tangent_error``'s ``error``
    takes them. ``data_weights`` (N,) makes row n count u_n times in the
    target v_total = scaling * sum_n u_n v_n (a subsample keeps the uniform
    draw and takes u of its rows)."""
    N = data.shape[0]
    u = None
    if data_weights is not None:
        u = torch.as_tensor(data_weights).to(dtype=data.dtype, device=data.device)
        if tuple(u.shape) != (N,):
            raise ValueError(f"data_weights must be ({N},), got {tuple(u.shape)}")
    st = state
    subsampled = n_subsample is not None and n_subsample < N
    if isinstance(draws, torch.Generator):
        samples, aux = sampler(draws, n_samples, st.wts, st.pts, st.sampler_aux)
        sub = draw_subsample(draws, N, n_subsample)[0] if subsampled else None
    else:
        z, sub = draws
        samples, aux = sampler.from_noise(z.to(data.device), st.wts, st.pts, st.sampler_aux)
        sub = None if sub is None else sub.to(data.device)
        if (sub is None) == subsampled:
            raise ValueError("refine_weights: the draws carry a subsample exactly when "
                             "n_subsample < N")
    if use_beta:
        proj = lambda pts: project_beta(model, pts, samples, st.beta)
    else:
        proj = lambda pts: project_ll(model, pts, samples)
    if sub is None:
        vecs = proj(data)
        v_total = vecs.sum(dim=0) if u is None else u @ vecs
    else:
        vecs = proj(data[sub])
        v_total = N / n_subsample * (vecs.sum(dim=0) if u is None else u[sub] @ vecs)
    mask = st.slot_mask
    Vc = proj(st.pts) * mask[:, None].to(data.dtype)        # (M, S)
    w_new = nnls_on_support(Vc.T, v_total, mask, st.wts.shape[0], n_iters=nnls_iters)
    # keep the polish only if it tightens the frozen objective
    err_old = torch.linalg.norm(Vc.T @ st.wts - v_total)
    err_new = torch.linalg.norm(Vc.T @ w_new - v_total)
    return st._replace(wts=torch.where(err_new <= err_old, w_new, st.wts), sampler_aux=aux)
