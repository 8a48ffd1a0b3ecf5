"""Streaming coreset construction by merge-reduce (counterpart of
betacores_tpu/coresets/streaming.py).

For data that does not sit next to the build on the card, or that arrives
in chunks: build an m_leaf-point coreset of every chunk (a leaf), then
summarise the union of the weighted leaf points with one final m_final
build. The final build's residual target sum_j u_j v_j (u_j the leaf
weights) is an unbiased sparse surrogate of the full-data tangent vector
sum_n v_n, because each leaf made sum_i w_i v_i ~= sum_{n in chunk} v_n in
the same tangent space. Above ``max_union_rows`` the union is itself
reduced, group by group and level by level, until it fits.

On the device:
  * every chunk is staged into ONE static (chunk_size, D) buffer with its
    (chunk_size,) row weights, from pinned host buffers on a card, and every
    leaf runs through ONE builder over those buffers
    (``IncrementalBuilder.build_with_data``), so the leaves share the
    builder's static pass buffers and captured CUDA graphs; the next
    chunk's host staging waits only for the previous copy, not for the
    previous leaf. Peak device memory is one chunk plus the leaf results;
  * the tail chunk is padded with its own first row at weight 0: a weight-0
    row adds nothing to the residual target and is never selected, so the
    padding is exact;
  * ``parallel_leaves=True`` puts every chunk on the device together and
    runs the lanes in turn through one builder (the reference vmaps them);
    each lane equals the streamed leaf bit for bit;
  * ``mesh=`` spreads the leaves over the mesh's data axis in rounds of
    n_data lanes: rank ax_d builds leaf r * n_data + ax_d of round r from
    its own chunk of the host array, and each round all-gathers the lanes'
    (wts, pts) packed into one tensor. The gathered leaves stay on the
    device, so no round waits for the host. Pad lanes (K rounded up to a
    multiple of n_data) hold row 0 of the data at weight 0 everywhere and
    reuse leaf 0's draws; their leaves are inert and sliced off.

Draws: each leaf, each reduction group and the final build has a
``torch.Generator`` of its own, seeded from (seed, stage, index) on the
host (``stage_seed``), so a build's draws do not depend on what ran before
it, and a resumed run is bit-identical to an uninterrupted one. ``draws``
replaces them: a callable (stage, index) -> a draws provider of
coresets/incremental.py (e.g. ``FixedDraws`` replaying the JAX package's
per-leaf draws), stage "leaf", ("reduce", level) or "final" (index 0).

Checkpoints (the streamed pass only): after every ``checkpoint_every``
leaves (and reduction groups) the results so far are written to an npz
with the reference's fields (``key_fp``, ``n_done``, ``wts``, ``pts`` and
the ``red_*`` fields of the reduction), to a temporary file first and then
``os.replace``d over the checkpoint. ``key_fp`` holds the seed. A rerun
with the same arguments resumes at the first unfinished leaf or group; a
checkpoint of another seed or shape raises. The file is removed once the
final build has succeeded.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import _Section
from .incremental import IncrementalConfig, make_incremental_builder
from .state import CoresetState, init_state


def stage_seed(seed: int, stage, index: int) -> int:
    """The seed of one build's generator: leaf ``index`` (stage "leaf"),
    group ``index`` of reduction level L (stage ("reduce", L)) or the final
    build (stage "final", index 0), spawned on the host from ``seed`` by
    ``np.random.SeedSequence``."""
    if stage == "leaf":
        spawn = (0, index)
    elif stage == "final":
        spawn = (2, index)
    elif isinstance(stage, tuple) and len(stage) == 2 and stage[0] == "reduce":
        spawn = (1, stage[1], index)
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return int(np.random.SeedSequence(seed, spawn_key=spawn).generate_state(1, np.uint64)[0])


def _fill(x: np.ndarray, u: np.ndarray, rows: np.ndarray, w=None, pad_row=None) -> None:
    """Rows ``rows`` at weights ``w`` (None: 1) into the head of ``x``,
    ``u``; the rest of ``x`` takes ``pad_row`` (None: ``rows[0]``) at
    weight 0."""
    n = rows.shape[0]
    x[:n] = rows
    x[n:] = rows[0] if pad_row is None else pad_row
    u[:n] = 1.0 if w is None else w
    u[n:] = 0.0


class _Stager:
    """A static (rows, D) device buffer ``x`` and its (rows,) weights ``u``.
    On a card they are filled from pinned host buffers by an asynchronous
    copy, and a fill waits only for the previous copy out of those buffers;
    on the CPU they are filled in place."""

    def __init__(self, rows: int, D: int, dtype: torch.dtype, device: torch.device):
        self.x = torch.empty((rows, D), dtype=dtype, device=device)
        self.u = torch.empty(rows, dtype=dtype, device=device)
        self.copied = None
        self.hx, self.hu = self.x, self.u
        if device.type == "cuda":
            self.hx = torch.empty((rows, D), dtype=dtype, pin_memory=True)
            self.hu = torch.empty(rows, dtype=dtype, pin_memory=True)
            self.copied = torch.cuda.Event()

    def fill(self, rows: np.ndarray, w=None, pad_row=None) -> None:
        if self.copied is not None:
            self.copied.synchronize()
        _fill(self.hx.numpy(), self.hu.numpy(), rows, w, pad_row)
        if self.copied is not None:
            self.x.copy_(self.hx, non_blocking=True)
            self.u.copy_(self.hu, non_blocking=True)
            self.copied.record()


def _timed(timings, name: str):
    """``timings.section(name)`` (utils/profiling.py), or with no
    ``timings`` a section that keeps no time and never synchronises."""
    return contextlib.nullcontext(_Section()) if timings is None else timings.section(name)


def merge_reduce_build(
    seed: int,
    data,
    model,
    sampler,
    leaf_config: IncrementalConfig,
    final_config: IncrementalConfig,
    chunk_size: int,
    m_leaf: int,
    m_final: int,
    st_leaf: CoresetState,
    st_final: Optional[CoresetState] = None,
    parallel_leaves: bool = False,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    max_union_rows: Optional[int] = None,
    draws: Optional[Callable] = None,
    device=None,
    timings=None,
) -> Tuple[CoresetState, torch.Tensor, torch.Tensor]:
    """Merge-reduce build: K = ceil(N / chunk_size) leaf builds of m_leaf
    selections each, then one final build of m_final selections over the
    K x M_buf_leaf leaf slots weighted by the leaf weights (the module
    docstring has the device layout, the draws and the checkpoints).

    ``data`` (N, D) is a host array (numpy, or a CPU tensor): chunks go to
    the device one at a time unless ``parallel_leaves``. ``st_leaf`` is the
    leaf state template (``init_state(M_buf, D, ...)``); ``st_final``
    defaults to a fresh m_final-slot state with st_leaf's beta and warm
    start. ``device``: where the builds run (None: the mesh's device, else
    the card). ``max_union_rows``: the hierarchical reduction's group size
    (at least twice M_buf). ``timings``: a utils/profiling.py ``Timings``
    that records each leaf ("leaf"), each checkpoint write with its host
    copy ("checkpoint"), each reduction group ("reduce") and the final
    build ("final"), each synchronised; None keeps no time and does not
    synchronise. Returns ``(final_state, leaf_pts, leaf_wts)``, the union
    the final build ran over (zero weight in unused slots)."""
    host = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)
    N, D = host.shape
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    if checkpoint_path is not None and (parallel_leaves or mesh is not None):
        raise ValueError(
            "checkpoint_path requires the streamed leaf pass "
            "(parallel_leaves=False, no mesh): batched/mesh leaf builds run "
            "as one program with nothing to checkpoint between — silently "
            "ignoring the flag would leave an hours-long run unprotected")
    if mesh is not None and device is None:
        device = mesh.device
    dev = resolve_device(device)
    if mesh is not None and dev != mesh.device:
        raise ValueError(f"device {dev} is not the mesh's {mesh.device}")
    K = math.ceil(N / chunk_size)
    st_leaf = CoresetState(*(t.to(dev) for t in st_leaf))
    dtype = st_leaf.wts.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    M_buf = st_leaf.wts.shape[0]

    def draws_for(builder, stage, index):
        if draws is not None:
            return draws(stage, index)
        gen = torch.Generator(device=dev).manual_seed(stage_seed(seed, stage, index))
        return builder.generator_draws(gen)

    def staged(rows):
        """A (rows, D) stager and one builder over its buffers."""
        stager = _Stager(rows, D, dtype, dev)
        return stager, make_incremental_builder(stager.x, model, sampler, leaf_config,
                                                data_weights=stager.u)

    def leaf(builder, stager, i, rows, pad_row=None):
        """Leaf ``i``'s build over ``rows`` (its draws: leaf i's)."""
        with _timed(timings, "leaf") as s:
            stager.fill(rows, pad_row=pad_row)
            return s.hold(builder.build_with_data(stager.x, stager.u, st_leaf, m_leaf,
                                                  draws_for(builder, "leaf", i)))

    chunk = lambda i: host[i * chunk_size:(i + 1) * chunk_size]
    key_fp = wts_acc = pts_acc = None
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS, require_axes

        n_lanes = require_axes(mesh)[0]
        stager, builder = staged(chunk_size)
        gathered = []
        for r in range(math.ceil(K / n_lanes)):
            i = r * n_lanes + mesh.ax_d
            if i < K:
                st_i = leaf(builder, stager, i, chunk(i))
            else:  # a pad lane: row 0 of the data at weight 0, leaf 0's draws
                st_i = leaf(builder, stager, 0, host[:0], pad_row=host[0])
            gathered.append(mesh.all_gather(torch.cat([st_i.wts[:, None], st_i.pts], dim=1),
                                            DATA_AXIS))
        lanes = torch.cat(gathered)[:K]                 # (K, M_buf, 1 + D), in leaf order
        leaf_wts = lanes[:, :, 0].reshape(-1)
        leaf_pts = lanes[:, :, 1:].reshape(-1, D)
    elif parallel_leaves:
        # every chunk on the device together; the lanes run in turn
        xs = np.empty((K, chunk_size, D), dtype=np_dtype)
        us = np.empty((K, chunk_size), dtype=np_dtype)
        for i in range(K):
            _fill(xs[i], us[i], chunk(i))
        xs, us = torch.from_numpy(xs).to(dev), torch.from_numpy(us).to(dev)
        builder = make_incremental_builder(xs[0], model, sampler, leaf_config,
                                           data_weights=us[0])
        sts = []
        for i in range(K):
            with _timed(timings, "leaf") as s:
                sts.append(s.hold(builder.build_with_data(xs[i], us[i], st_leaf, m_leaf,
                                                          draws_for(builder, "leaf", i))))
        leaf_wts = torch.cat([st.wts for st in sts])
        leaf_pts = torch.cat([st.pts for st in sts])
    else:
        stager, builder = staged(chunk_size)
        i0 = 0
        if checkpoint_path is not None:
            # one host copy per leaf; without checkpoints the leaves stay
            # on the device and the next chunk's staging overlaps this build
            wts_acc = np.zeros((K, M_buf), dtype=np_dtype)
            pts_acc = np.zeros((K, M_buf, D), dtype=np_dtype)
            key_fp = np.asarray([seed], dtype=np.int64)
            i0 = _load_leaf_checkpoint(checkpoint_path, key_fp, (K, M_buf, D),
                                       wts_acc, pts_acc)
        wts_list, pts_list = [], []
        for i in range(i0, K):
            st_i = leaf(builder, stager, i, chunk(i))
            if checkpoint_path is not None:
                with _timed(timings, "checkpoint"):
                    wts_acc[i] = st_i.wts.cpu().numpy()
                    pts_acc[i] = st_i.pts.cpu().numpy()
                    if (i + 1) % max(1, checkpoint_every) == 0 or i == K - 1:
                        _save_leaf_checkpoint(checkpoint_path, key_fp, i + 1, wts_acc, pts_acc)
            else:
                wts_list.append(st_i.wts)
                pts_list.append(st_i.pts)
        if checkpoint_path is not None:
            leaf_wts = torch.from_numpy(wts_acc.reshape(-1)).to(dev)
            leaf_pts = torch.from_numpy(pts_acc.reshape(-1, D)).to(dev)
        else:
            leaf_wts, leaf_pts = torch.cat(wts_list), torch.cat(pts_list)

    if max_union_rows is not None:
        # hierarchical reduction: groups of max_union_rows weighted rows are
        # summarised into m_leaf-point coresets until the union fits, all
        # through ONE builder over a static (max_union_rows, D) buffer
        if max_union_rows < 2 * M_buf:
            raise ValueError(
                f"max_union_rows ({max_union_rows}) must be >= 2x the leaf "
                f"buffer ({M_buf}) or each level cannot shrink the union")
        red_stager = red_builder = None
        level, g0 = 0, 0
        out_w = out_p = None
        if checkpoint_path is not None:
            red = _load_reduction_checkpoint(checkpoint_path, key_fp)
            if red is not None:
                level, g0, in_w, in_p, out_w, out_p = red
                leaf_wts = torch.from_numpy(in_w).to(dev)
                leaf_pts = torch.from_numpy(in_p).to(dev)
        while leaf_wts.shape[0] > max_union_rows:
            R = leaf_wts.shape[0]
            G = math.ceil(R / max_union_rows)
            w_np = np.zeros(G * max_union_rows, dtype=np_dtype)  # pad rows: weight 0, inert
            p_np = np.zeros((G * max_union_rows, D), dtype=np_dtype)
            w_np[:R] = leaf_wts.cpu().numpy()
            p_np[:R] = leaf_pts.cpu().numpy()
            if red_builder is None:
                red_stager, red_builder = staged(max_union_rows)
            if out_w is None:
                out_w = np.zeros((G, M_buf), dtype=np_dtype)
                out_p = np.zeros((G, M_buf, D), dtype=np_dtype)
            for g in range(g0, G):
                sl = slice(g * max_union_rows, (g + 1) * max_union_rows)
                with _timed(timings, "reduce") as s:
                    red_stager.fill(p_np[sl], w_np[sl])
                    st_g = s.hold(red_builder.build_with_data(
                        red_stager.x, red_stager.u, st_leaf, m_leaf,
                        draws_for(red_builder, ("reduce", level), g)))
                out_w[g] = st_g.wts.cpu().numpy()
                out_p[g] = st_g.pts.cpu().numpy()
                if checkpoint_path is not None and ((g + 1) % max(1, checkpoint_every) == 0
                                                    or g == G - 1):
                    _save_leaf_checkpoint(checkpoint_path, key_fp, K, wts_acc, pts_acc,
                                          red=(level, g + 1, w_np[:R], p_np[:R], out_w, out_p))
            leaf_wts = torch.from_numpy(out_w.reshape(-1)).to(dev)
            leaf_pts = torch.from_numpy(out_p.reshape(-1, D)).to(dev)
            level += 1
            g0 = 0
            out_w = out_p = None

    if st_final is None:
        st_final = init_state(m_final, D, beta=float(st_leaf.beta), dtype=dtype, device=dev)
        st_final = st_final._replace(sampler_aux=st_leaf.sampler_aux)
    st_final = CoresetState(*(t.to(dev) for t in st_final))
    final_builder = make_incremental_builder(leaf_pts, model, sampler, final_config,
                                             data_weights=leaf_wts)
    with _timed(timings, "final") as s:
        final_state = s.hold(final_builder.build(st_final, m_final,
                                                 draws_for(final_builder, "final", 0)))
    if checkpoint_path is not None:
        with contextlib.suppress(OSError):
            os.remove(checkpoint_path)
    return final_state, leaf_pts, leaf_wts


def _save_leaf_checkpoint(path: str, key_fp: np.ndarray, n_done: int,
                          wts_acc: np.ndarray, pts_acc: np.ndarray, red=None) -> None:
    """Atomic (temporary file, then ``os.replace``) save of the leaf pass so
    far; with ``red`` = (level, g_done, in_w, in_p, out_w, out_p) the
    reduction's progress rides in the same file (the leaf section stays, so
    a resume still validates against it)."""
    extra = {}
    if red is not None:
        level, g_done, in_w, in_p, out_w, out_p = red
        extra = dict(red_level=np.int64(level), red_g_done=np.int64(g_done),
                     red_in_w=in_w, red_in_p=in_p, red_out_w=out_w, red_out_p=out_p)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, key_fp=key_fp, n_done=np.int64(n_done), wts=wts_acc, pts=pts_acc, **extra)
    os.replace(tmp, path)


def _check_seed(z, path: str, key_fp: np.ndarray) -> None:
    if not np.array_equal(np.asarray(z["key_fp"]), key_fp):
        raise ValueError(f"streaming checkpoint {path!r} was written under a different "
                         f"seed — pass the original seed or delete the file")


def _load_reduction_checkpoint(path: str, key_fp: np.ndarray):
    """(level, g_done, in_w, in_p, out_w, out_p) of an interrupted
    reduction, or None."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "red_level" not in z.files:
            return None
        _check_seed(z, path, key_fp)
        return (int(z["red_level"]), int(z["red_g_done"]),
                z["red_in_w"], z["red_in_p"], z["red_out_w"], z["red_out_p"])


def _load_leaf_checkpoint(path: str, key_fp: np.ndarray, shape3, wts_acc, pts_acc) -> int:
    """The leaves already done (copied into ``wts_acc``, ``pts_acc``), or 0
    without a checkpoint. Raises if the checkpoint belongs to another seed
    or problem shape: resuming another stream would corrupt the result."""
    if not os.path.exists(path):
        return 0
    K, M_buf, D = shape3
    with np.load(path) as z:
        _check_seed(z, path, key_fp)
        if z["wts"].shape != (K, M_buf) or z["pts"].shape != (K, M_buf, D):
            raise ValueError(
                f"streaming checkpoint {path!r} shape {z['wts'].shape} does "
                f"not match this problem (K={K}, M_buf={M_buf}, d={D}) — "
                f"delete the file to start over")
        n_done = int(z["n_done"])
        wts_acc[:n_done] = z["wts"][:n_done]
        pts_acc[:n_done] = z["pts"][:n_done]
    return n_done
