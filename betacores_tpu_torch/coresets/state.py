"""Static-shape coreset state (counterpart of betacores_tpu/coresets/state.py).

The coreset lives in pre-allocated (M_max, ...) buffers with an active-slot
count ``m``: slot k < m holds a selected point (its weight may be 0 after
refinement); slots >= m are padding, masked out of every reduction, with
index -1. ``m`` is a 0-d int32 tensor on the state's device, so the build
loop never reads it on the host.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch


class CoresetState(NamedTuple):
    wts: torch.Tensor          # (M_max,)
    idcs: torch.Tensor         # (M_max,) int32; -1 in padding slots
    pts: torch.Tensor          # (M_max, D)
    m: torch.Tensor            # 0-d int32: active slot count
    beta: torch.Tensor         # 0-d: beta-divergence parameter
    sampler_aux: torch.Tensor  # (d,) Laplace warm-start mode

    @property
    def slot_mask(self) -> torch.Tensor:
        return torch.arange(self.wts.shape[0], device=self.wts.device) < self.m


class GroupCoresetState(NamedTuple):
    """The group builder's state (coresets/groups.py)."""

    core: CoresetState
    selected: torch.Tensor      # (G,) bool: the group is in the coreset
    initialized: torch.Tensor   # 0-d int32: warm-start slots left out of the
                                # take-new comparison


def init_state(max_size: int, dim: int, beta: float = 0.5,
               sampler_aux: torch.Tensor | None = None,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> CoresetState:
    if sampler_aux is None:
        sampler_aux = torch.zeros(dim, dtype=dtype, device=device)
    return CoresetState(
        wts=torch.zeros(max_size, dtype=dtype, device=device),
        idcs=torch.full((max_size,), -1, dtype=torch.int32, device=device),
        pts=torch.zeros((max_size, dim), dtype=dtype, device=device),
        m=torch.zeros((), dtype=torch.int32, device=device),
        beta=torch.tensor(beta, dtype=dtype, device=device),
        sampler_aux=sampler_aux,
    )


def warm_start_state(max_size: int, wts, idcs, pts, beta: float = 0.5,
                     sampler_aux: torch.Tensor | None = None,
                     device: torch.device | str = "cuda") -> CoresetState:
    """A state seeded with an existing coreset (the reference's constructor
    warm start ``wts``/``idcs``/``pts``): its k points fill slots 0..k-1
    and m = k. The indices may lie outside the data (sentinel points whose
    coordinates live only in ``pts``). The buffers are assembled on the
    host and copied to ``device`` once; the weights' dtype is kept."""
    wts = np.asarray(wts)
    pts = np.atleast_2d(np.asarray(pts))
    k, d = pts.shape
    w_buf = np.zeros(max_size, dtype=wts.dtype)
    i_buf = np.full(max_size, -1, dtype=np.int32)
    p_buf = np.zeros((max_size, d), dtype=wts.dtype)
    w_buf[:k] = wts
    i_buf[:k] = np.asarray(idcs, dtype=np.int32)
    p_buf[:k] = pts
    t = lambda a: torch.from_numpy(a).to(device)
    dtype = torch.from_numpy(w_buf[:0]).dtype
    if sampler_aux is None:
        sampler_aux = torch.zeros(d, dtype=dtype, device=device)
    return CoresetState(wts=t(w_buf), idcs=t(i_buf), pts=t(p_buf),
                        m=torch.full((), k, dtype=torch.int32, device=device),
                        beta=torch.full((), beta, dtype=dtype, device=device),
                        sampler_aux=sampler_aux)


def get(state: CoresetState):
    """(wts, pts, idcs) of the strictly-positive-weight support, as numpy
    arrays (the reference's ``Coreset.get()`` filter). Eager: the shape
    depends on the data."""
    w = state.wts.cpu().numpy()
    keep = w > 0
    return w[keep], state.pts.cpu().numpy()[keep], state.idcs.cpu().numpy()[keep]


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: torch.device | str = "cuda") -> CoresetState:
    """A state from numpy arrays keyed by the field names (e.g. a JAX
    ``CoresetState._asdict()`` passed through ``np.asarray``). Dtypes are
    kept, except that ``idcs`` and ``m`` are int32. The arrays are copied."""
    def t(name, dtype=None):
        return torch.tensor(np.array(arrays[name]), dtype=dtype, device=device)

    return CoresetState(wts=t("wts"), idcs=t("idcs", torch.int32),
                        pts=t("pts"), m=t("m", torch.int32), beta=t("beta"),
                        sampler_aux=t("sampler_aux"))


def state_to_numpy(state: CoresetState) -> dict:
    """The inverse of ``state_from_numpy``: field name -> numpy array."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def group_state_from_numpy(arrays: Mapping[str, object],
                           device: torch.device | str = "cuda"):
    """A group state (``GroupCoresetState``) from numpy
    arrays: ``arrays["core"]`` as ``state_from_numpy`` takes it,
    ``selected`` (G,) and ``initialized`` (e.g. a JAX ``GroupCoresetState``
    passed through ``np.asarray`` field by field). The arrays are copied."""
    return GroupCoresetState(
        core=state_from_numpy(arrays["core"], device),
        selected=torch.tensor(np.array(arrays["selected"]), dtype=torch.bool, device=device),
        initialized=torch.tensor(np.array(arrays["initialized"]), dtype=torch.int32,
                                 device=device))
