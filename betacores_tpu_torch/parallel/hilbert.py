"""The sharded Hilbert coreset: a data-parallel projection and a
distributed GIGA (counterpart of betacores_tpu/parallel/hilbert.py).

The (N, S) projection is row-sharded over the mesh's ``data`` axis, one
block a rank, and every GIGA iteration runs as

  * LOCAL scoring: each rank scores its own unit rows against the
    replicated geodesic direction (one (N_loc, S) x (S, 2) product, the
    single-device solver's own arithmetic, snnls/giga.py::giga_scores);
  * a DISTRIBUTED ARGMAX: each rank's first maximum, then one all_gather
    over ``data`` of (row, score, weight) and a replicated first-argmax.
    The gathered order is rank order, so an exact tie goes to the lower
    shard, as the single-device first-argmax over the same row order;
  * the REPLICATED geodesic reweight (snnls/giga.py::geodesic_reweight,
    shared with the single-device step); the S-dim iterate ``xw`` is one
    psum over ``data``.

The build driver, with its monotone check, retry and latch, is
snnls/base.py's: its state (w, retried, latched) is (sharded, replicated,
replicated) and its branches are replicated. The ``samp`` axis, if any, is
pure replication: every rank needs whole rows of S for the argmax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.projection import project_beta, project_ll
from ..snnls import base as snnls_base
from ..snnls.giga import geodesic_reweight, giga_scores
from ..utils import errors
from .mesh import DATA_AXIS, Mesh, require_axes


class ShardedHilbertCoreset:
    """``SparseNNLS``'s and ``HilbertCoreset``'s surface (``build``,
    ``build_trace``, ``weights``, ``error``, ``size``, ``reset``,
    ``reached_numeric_limit``, ``get``) over a row-sharded dataset.

    ``data_sharded, n_true`` come from ``parallel.shard_data`` (this rank's
    zero-padded row block and N); ``samples`` is the replicated (S,
    theta_dim) posterior sample array (draw it once from the model's
    sampler, as the single-device HilbertCoreset does); ``beta`` switches
    the tangent space to beta-likelihood projections. Every method is a
    collective: all ranks call it, in the same order."""

    def __init__(self, data_sharded: torch.Tensor, n_true: int, model, samples: torch.Tensor,
                 mesh: Mesh, beta: Optional[float] = None):
        require_axes(mesh)
        self.data, self.n_true, self.mesh, self.model = data_sharded, int(n_true), mesh, model
        self.reached_numeric_limit = False
        rows_loc = data_sharded.shape[0]
        dev, dtype = data_sharded.device, data_sharded.dtype
        samples = torch.as_tensor(samples).to(dtype=dtype, device=dev)
        # project once: the padding rows are zero points, not zero projections
        if beta is None:
            vecs = project_ll(model, data_sharded, samples)
        else:
            vecs = project_beta(model, data_sharded, samples,
                                torch.tensor(beta, dtype=dtype, device=dev))
        valid = mesh.ax_d * rows_loc + torch.arange(rows_loc, device=dev) < self.n_true
        vecs = vecs * valid[:, None].to(dtype)
        norms = torch.sqrt(torch.sum(vecs * vecs, dim=1))
        # zero-norm rows are inert, as the single-device class drops them
        self._selectable = valid & (norms > 0)
        self._vecs = vecs
        self._unit = vecs / torch.where(norms > 0, norms, torch.inf)[:, None]
        self._b = mesh.psum(vecs.sum(dim=0), DATA_AXIS)
        self.reset()

    def _error(self, w: torch.Tensor) -> torch.Tensor:
        """||psum(vecs^T w) - b||: the one residual of both the build's
        monotone check and ``error()``."""
        return torch.linalg.norm(self.mesh.psum(self._vecs.T @ w, DATA_AXIS) - self._b)

    def _step_fn(self):
        tol = errors.TOL
        mesh, vecs = self.mesh, self._vecs
        bnorm = torch.linalg.norm(self._b)
        bn = self._b / torch.where(bnorm == 0.0, 1.0, bnorm)
        S = vecs.shape[1]

        def step(w):
            # vecs^T w, as the single-device step's A @ w (the same product)
            xw = mesh.psum(vecs.T @ w, DATA_AXIS)           # (S,), replicated
            scores, xwn, nw, ok_select = giga_scores(self._unit, xw, bn, tol)
            scores = torch.where(self._selectable, scores, -torch.inf)
            best = torch.argmax(scores).view(1)
            # (row, score, weight): the row first, so the winner's row starts
            # its buffer as the single-device step's column does (a reduction
            # over a misaligned view may round otherwise)
            cand = torch.cat([vecs.index_select(0, best)[0], scores.index_select(0, best),
                              w.index_select(0, best)])
            g = mesh.all_gather(cand, DATA_AXIS)            # (n_data, S + 2)
            win = torch.argmax(g[:, S])                     # ties: the lower shard
            top = g.index_select(0, win.view(1))[0]
            a, scale, new_wf, ok_geo = geodesic_reweight(xw, nw, xwn, top[:S], top[S + 1],
                                                         bn, bnorm)
            w_new = a * scale * w
            w_new = torch.where(win == mesh.ax_d, w_new.scatter(0, best, new_wf.view(1)),
                                w_new)
            return w_new, ok_select & ok_geo & torch.isfinite(top[S])

        return step

    def build(self, itrs: int) -> None:
        if self.reached_numeric_limit:
            return
        self._finish(snnls_base.build(self._step_fn(), self._error, self.w, int(itrs)))

    def build_trace(self, itrs: int) -> torch.Tensor:
        """(itrs, N_loc): this rank's block of the weights after each
        iteration; row m - 1 is the weights after m iterations in all."""
        ws, st = snnls_base.build_trace(self._step_fn(), self._error, self.w, int(itrs))
        self._finish(st)
        return ws

    def _finish(self, st: snnls_base.BuildState) -> None:
        self.w = st.w
        if bool(st.latched):          # sticky, as SparseNNLS's
            self.reached_numeric_limit = True

    def error(self) -> float:
        return float(self._error(self.w))

    def size(self) -> int:
        return int(self.mesh.psum((self.w > 0).sum().to(self.w.dtype), DATA_AXIS))

    def weights(self) -> np.ndarray:
        """A host copy of the weights over the true (unpadded) rows."""
        return self.mesh.all_gather(self.w, DATA_AXIS).reshape(-1)[:self.n_true].cpu().numpy()

    def reset(self) -> None:
        self.w = torch.zeros(self.data.shape[0], dtype=self.data.dtype, device=self.data.device)
        self.reached_numeric_limit = False

    def get(self):
        """(wts, pts, idcs) of the selected rows, the reference's
        ``Coreset.get()``. Each rank contributes the selected rows of its
        own block to one psum of (k, D): the dataset is never gathered."""
        w = self.weights()
        idcs = np.flatnonzero(w > 0)
        rows_loc = self.data.shape[0]
        local = idcs - self.mesh.ax_d * rows_loc
        mine = (local >= 0) & (local < rows_loc)
        pts = torch.zeros((len(idcs), self.data.shape[1]), dtype=self.data.dtype,
                          device=self.data.device)
        pts[torch.from_numpy(np.flatnonzero(mine)).to(pts.device)] = \
            self.data[torch.from_numpy(local[mine]).to(pts.device)]
        return w[idcs], self.mesh.psum(pts, DATA_AXIS).cpu().numpy(), idcs
