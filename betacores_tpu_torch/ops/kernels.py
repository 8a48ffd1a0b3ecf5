"""The port's hand-written kernels and their operand packers (counterpart of
betacores_tpu/ops/pallas_kernels.py).

Each wrapper launches its kernel on a CUDA tensor or raises; on a CPU
tensor it runs the kernel's plain PyTorch version, which the CPU tests and
the on-card comparison use. There is no fallback between the two. Each
wrapper counts its kernel launches in ``<wrapper>.launches``; a launch
captured in a CUDA graph is counted at every replay (utils/graphs.py).

- ``logreg_adam_step`` (K1): one whole projected-Adam refinement step of
  the incremental build in one launch of one thread-block cluster (CUDA
  C++, csrc/logreg_adam_step.cu); plain version ``logreg_adam_step_plain``.
- ``multiclass_projection`` (K2): the centred (N, S) K-class softmax
  (beta-)log-likelihood projection in one pass (CUDA C++,
  csrc/multiclass_projection.cu); plain version
  ``multiclass_projection_plain``. The projection engine routes row
  blocks of at least ``FUSED_MIN_ROWS`` to it (``maybe_fused``). Its
  plan (theta in registers or in shared memory, live threads, rows per
  tile) is mirrored by ``mc_plan``, its walk over a tile by ``mc_work``.
- ``logreg_shard_step_partials`` (K3): the shard-local, uncentred half of
  one sharded refinement step (each row's values shifted by its value at
  the Laplace mode) in one launch of one thread-block cluster
  (CUDA C++, csrc/logreg_shard_partials.cu); plain version
  ``logreg_shard_step_partials_plain``. The sharded builder
  (parallel/sharded.py) combines its partials across ranks.

K1 and K3 split the packed rows over the C CTAs of their cluster
(``cluster_rows``, C from ``cluster_size``) and sum across the cluster
through distributed shared memory (csrc/logreg_common.cuh).

The K1 and K2 wrappers call ``torch.library`` ops
(``betacores_torch::logreg_adam_step``, ``betacores_torch::multiclass_projection``):
functional (fresh outputs, no argument mutated), a CPU kernel that is the
plain version, a CUDA kernel that is the launch, and a fake that gives the
shapes, so that a traced or exported program holds each as one node
(utils/export.py). K3 has none: no exported program runs it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.base import identity
from ..utils.graphs import counted, signature
from ..utils.opt import adam_bias_corrections
from .projection import center

# MUST match utils/opt.py::nn_adam of the reference (b1, b2, eps); the
# CUDA source repeats them
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# CTAs of one cluster the card takes (9..16 with the non-portable opt-in);
# csrc/logreg_common.cuh repeats it
MAX_CLUSTER = 16


def cluster_size(R: int) -> int:
    """CTAs in K1's and K3's cluster for R packed rows: the smallest power
    of two in [2, 16] that leaves each CTA at most 24 rows (1.5 per warp of
    16). At the main path's 328 rows that is 16, the fastest of 1..16
    measured on an H100 (PERF.md)."""
    C = 2
    while C < MAX_CLUSTER and -(-R // C) > 24:
        C *= 2
    return C


def cluster_rows(R: int, n_sub_pad: int, M_pad: int, C: int) -> list[tuple[list, list]]:
    """For each CTA of a C-CTA cluster, (rows, slots): the packed rows it
    walks, in its order, and the buffer slots whose centred core row and
    Adam update it keeps, as the kernels split them
    (csrc/logreg_common.cuh::RowSplit, the same closed forms): subsample
    row r to CTA r mod C, buffer slot m (packed row n_sub_pad + m) to CTA
    m mod C; a CTA walks its subsample rows, then its slots' rows. The
    sample axis is never split."""
    if R != n_sub_pad + M_pad:
        raise ValueError(f"R={R} is not n_sub_pad + M_pad = {n_sub_pad + M_pad}")
    out = []
    for c in range(C):
        n_sub = -(-(n_sub_pad - c) // C) if c < n_sub_pad else 0
        n_core = -(-(M_pad - c) // C) if c < M_pad else 0
        slots = [c + j * C for j in range(n_core)]
        out.append(([c + i * C for i in range(n_sub)] + [n_sub_pad + m for m in slots], slots))
    return out


def logreg_adam_step_plain(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true: int,
                           use_beta: bool = False):
    """(w', m1', m2') of one projected-Adam refinement step, in plain
    PyTorch, on the operands of ``logreg_adam_step``. Padding of any size
    is allowed: padded sample rows of ``z`` are sliced off, padded rows of
    ``xin`` carry mask 0, padded Adam slots have zero core rows."""
    from ..models import logreg

    d = xin.shape[1] - 1
    n_sub_pad = xin.shape[0] - w.shape[1]
    th = z[:s_true] @ linv + mu                                   # (S, d)
    x, msk = xin[:, :d], xin[:, d:]
    ll = (logreg.beta_likelihood(x, th, sc[0]) if use_beta
          else logreg.log_likelihood(x, th))
    vals = center(ll) * msk                                       # (R, S)
    sub, core = vals[:n_sub_pad], vals[n_sub_pad:]
    resid = sc[1] * sub.sum(dim=0) - w[0] @ core
    g = -(core @ resid) / s_true
    m1n = ADAM_B1 * m1 + (1.0 - ADAM_B1) * g
    m2n = ADAM_B2 * m2 + (1.0 - ADAM_B2) * g * g
    w_new = torch.clamp_min(
        w - sclr[0] * (m1n / sclr[1]) / (ADAM_EPS + torch.sqrt(m2n / sclr[2])), 0.0)
    return w_new, m1n, m2n


@functools.cache
def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("logreg_adam_step")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.logreg_adam_step.argtypes = [vp] * 12 + [ci] * 6 + [vp]
    lib.logreg_adam_step.restype = ci
    lib.logreg_adam_step_smem_bytes.argtypes = [ci] * 5
    lib.logreg_adam_step_smem_bytes.restype = ctypes.c_longlong
    lib.logreg_adam_step_floor.argtypes = [ci] * 5 + [vp]
    lib.logreg_adam_step_floor.restype = ci
    return lib


def _check_tensors(want: dict, **ops):
    """Every operand float32, contiguous, on the first operand's device and
    of the shape ``want[name]``."""
    dev = next(iter(ops.values())).device
    for name, t in ops.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the first operand on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_step_layout(R: int, s_rows: int, M_pad: int, s_true: int):
    if not 1 <= s_true <= s_rows:
        raise ValueError(f"s_true={s_true} outside [1, {s_rows}]")
    if not 1 <= M_pad <= R:
        raise ValueError(f"M_pad={M_pad} outside [1, R={R}]")


def _check_smem(what: str, smem: int, device, shape: str):
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{what} needs {smem} B of shared memory, the card "
                         f"allows {limit} B per block ({shape})")


def _check_operands(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true):
    R, D1 = xin.shape
    d, M_pad = D1 - 1, w.shape[-1]
    _check_tensors({"xin": (R, D1), "z": (z.shape[0], d), "mu": (1, d),
                    "linv": (d, d), "w": (1, M_pad), "m1": (1, M_pad),
                    "m2": (1, M_pad), "sc": (2,), "sclr": (3,)},
                   xin=xin, z=z, mu=mu, linv=linv, w=w, m1=m1, m2=m2, sc=sc, sclr=sclr)
    _check_step_layout(R, z.shape[0], M_pad, s_true)


def logreg_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true: int,
                     use_beta: bool = False):
    """(w', m1', m2') of one projected-Adam refinement step in ONE launch.

    Operands (float32, contiguous, on one device): xin (n_sub_pad + M_pad,
    d+1) rows [x | mask], subsample rows first; z (s_pad >= s_true, d)
    pre-drawn noise; mu (1, d) and linv (d, d) = L^-1 of the current Laplace
    fit (theta = mu + z @ L^-1); w, m1, m2 (1, M_pad) Adam state;
    sc = [beta, sum_scaling]; sclr = [lr, 1-b1^t, 1-b2^t]. The call is the
    op ``betacores_torch::logreg_adam_step``, so a traced or exported
    program holds it as one node."""
    if xin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {xin.device}")
    return torch.ops.betacores_torch.logreg_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr,
                                                      int(s_true), bool(use_beta))


@torch.library.custom_op("betacores_torch::logreg_adam_step", mutates_args=())
def _adam_step_op(xin: torch.Tensor, z: torch.Tensor, mu: torch.Tensor, linv: torch.Tensor,
                  w: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor, sc: torch.Tensor,
                  sclr: torch.Tensor, s_true: int,
                  use_beta: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as a functional op: fresh (w', m1', m2'), no argument mutated. The
    CPU kernel is the plain version, the CUDA kernel the launch; a device
    without a kernel raises."""
    raise NotImplementedError(f"no kernel for device {xin.device}")


@_adam_step_op.register_kernel("cpu")
def _(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true, use_beta):
    return logreg_adam_step_plain(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true, use_beta)


@_adam_step_op.register_kernel("cuda")
def _(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true, use_beta):
    out = launch_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true, use_beta,
                           cluster_size(xin.shape[0]))
    logreg_adam_step.launches += 1
    return out


@_adam_step_op.register_fake
def _(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true, use_beta):
    return tuple(torch.empty_like(w) for _ in range(3))


def launch_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true: int,
                     use_beta: bool, cluster: int):
    """K1's launch as one cluster of ``cluster`` CTAs on CUDA operands,
    uncounted: ``logreg_adam_step`` with the cluster size given, for
    measuring each size on the card."""
    _check_operands(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true)
    R, D1 = xin.shape
    M_pad = w.shape[1]
    lib = _lib()
    _check_smem("step", lib.logreg_adam_step_smem_bytes(R, D1 - 1, s_true, M_pad, cluster),
                xin.device, f"R={R}, M_pad={M_pad}, S={s_true}, d={D1 - 1}, C={cluster}")
    w_out, m1_out, m2_out = (torch.empty_like(w) for _ in range(3))
    with torch.cuda.device(xin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.logreg_adam_step(
            xin.data_ptr(), z.data_ptr(), mu.data_ptr(), linv.data_ptr(),
            w.data_ptr(), m1.data_ptr(), m2.data_ptr(), sc.data_ptr(),
            sclr.data_ptr(), w_out.data_ptr(), m1_out.data_ptr(),
            m2_out.data_ptr(), R, D1 - 1, s_true, M_pad, int(use_beta), cluster, stream)
    if rc != 0:
        raise RuntimeError(f"logreg_adam_step launch of a {cluster}-CTA cluster failed: "
                           f"cudaError {rc}")
    return w_out, m1_out, m2_out


counted(logreg_adam_step)


# ---------------------------------------------------------------------------
# K2: the K-class softmax projection
# ---------------------------------------------------------------------------

# Row blocks of at least this many rows go to a model's fused projection
# (ops/projection.py), and smaller ones to the plain composition: the
# reference's value, so that the port routes the same rows to the kernel.
FUSED_MIN_ROWS = 8192
# the kernel's limits (csrc/multiclass_projection.cu repeats them)
MC_MAX_CLASSES, MC_MAX_FEATURES = 16, 32
# its block, theta's register budget, the values a thread computes per tile
# (csrc/multiclass_projection.cu: kThreads, kRegBudget, kMaxRegD, kTileValues)
MC_THREADS, MC_REG_BUDGET, MC_MAX_REG_D, MC_TILE_VALUES = 800, 65, 10, 16


class McPlan(NamedTuple):
    """How one K2 launch covers its shapes: D the padded d of theta in
    registers (0: theta in shared memory), ``live`` threads of a block
    working, ``rows`` per tile, ``smem`` bytes of dynamic shared memory."""
    D: int
    live: int
    rows: int
    smem: int


def mc_plan(d: int, K: int, S: int, smem_limit: int) -> McPlan:
    """K2's plan for a block allowed ``smem_limit`` bytes of shared memory
    (csrc/multiclass_projection.cu::make_plan, the same closed forms)."""
    D = d + d % 2
    reg = S <= MC_THREADS and D <= MC_MAX_REG_D and K * (D + 3) <= MC_REG_BUDGET
    live = (MC_THREADS // S) * S if reg else MC_THREADS
    per_row = 2 * (_round_up(d + 1, 4) + S + 1)
    fixed = 4 + (0 if reg else d * K * S)          # beta's constants, theta
    fit = int((smem_limit // 4 - fixed) / per_row)    # C's division truncates
    rows = min(MC_TILE_VALUES * live // S, fit)
    if reg and rows >= live // S:
        rows -= rows % (live // S)
    rows = max(rows, 1)
    return McPlan(D if reg else 0, live, rows, 4 * (fixed + per_row * rows))


def mc_work(N: int, S: int, plan: McPlan, grid: int):
    """The (block, row, sample) triples K2 computes, then those it stores,
    walked as the kernel's loops walk them (for testing): block b takes
    tiles b, b + grid, ...; thread t < live computes the tile's pairs from
    (t // S, t % S) in steps of ``live`` pairs, and every thread stores the
    centred pairs from the same start in steps of MC_THREADS, both carried
    as a row and a sample index."""
    def walk(t, step, nr):
        r, s = divmod(t, S)
        dr, ds = divmod(step, S)
        while r < nr:
            yield r, s
            r, s = r + dr, s + ds
            if s >= S:
                r, s = r + 1, s - S

    computed, stored = [], []
    T = plan.rows
    for b in range(grid):
        for tile in range(b, -(-N // T), grid):
            row0, nr = tile * T, min(T, N - tile * T)
            for t in range(MC_THREADS):
                if t < plan.live:
                    computed += [(b, row0 + r, s) for r, s in walk(t, plan.live, nr)]
                stored += [(b, row0 + r, s) for r, s in walk(t, MC_THREADS, nr)]
    return computed, stored


def maybe_fused(n_rows: int) -> bool:
    return n_rows >= FUSED_MIN_ROWS


def multiclass_projection_plain(z, thetas, n_classes: int, beta=1.0,
                                use_beta: bool = False):
    """The centred (N, S) projection of ``multiclass_projection`` as the
    plain composition of models/multiclass.py."""
    from ..models import multiclass

    if use_beta:
        return center(multiclass.make_beta_likelihood(n_classes)(z, thetas, beta))
    return center(multiclass.make_log_likelihood(n_classes)(z, thetas))


@functools.cache
def _mc_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("multiclass_projection")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.multiclass_projection.argtypes = [vp] * 4 + [ll] + [ci] * 4 + [vp]
    lib.multiclass_projection.restype = ci
    lib.multiclass_projection_plan.argtypes = [ci, ci, ci, ll, ctypes.POINTER(ll)]
    lib.multiclass_projection_plan.restype = None
    lib.multiclass_projection_floor.argtypes = [vp, ll, ci, ci, ci, vp]
    lib.multiclass_projection_floor.restype = ci
    return lib


def mc_plan_built(d: int, K: int, S: int, smem_limit: int) -> McPlan:
    """K2's plan as the built kernel computes it (``mc_plan`` mirrors it)."""
    out = (ctypes.c_longlong * 4)()
    _mc_lib().multiclass_projection_plan(d, K, S, smem_limit, out)
    return McPlan(*(int(v) for v in out))


def _check_mc_operands(z, thetas, n_classes: int):
    d = z.shape[1] - 1
    for name, t in (("z", z), ("thetas", thetas)):
        if t.device != z.device:
            raise ValueError(f"{name} on {t.device}, z on {z.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if thetas.dim() != 2 or thetas.shape[1] != n_classes * d:
        raise ValueError(f"thetas has shape {tuple(thetas.shape)}, "
                         f"want (S, {n_classes * d})")
    if not 2 <= n_classes <= MC_MAX_CLASSES:
        raise ValueError(f"the kernel takes 2 <= K <= {MC_MAX_CLASSES}, got {n_classes}")
    if not 1 <= d <= MC_MAX_FEATURES:
        raise ValueError(f"the kernel takes 1 <= d <= {MC_MAX_FEATURES}, got {d}")


def multiclass_projection(z, thetas, n_classes: int, beta=1.0,
                          use_beta: bool = False):
    """Centred (N, S) K-class softmax log-likelihood projection, or its
    beta-likelihood with ``use_beta``, in ONE launch.

    ``z`` (N, d+1) rows [x | y] with the class index as a float in the last
    column; ``thetas`` (S, K*d) packed row-major (K, d); ``beta`` a float
    or a tensor with one element on z's device (read by the kernel, never
    on the host). On the card both operands are float32 and contiguous,
    d <= 32 and 2 <= K <= 16. The call is the op
    ``betacores_torch::multiclass_projection``."""
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {z.device}")
    beta_t = beta if isinstance(beta, torch.Tensor) else None
    beta_f = 1.0 if beta_t is not None else float(beta)
    return torch.ops.betacores_torch.multiclass_projection(z, thetas, int(n_classes), beta_f,
                                                           beta_t, bool(use_beta))


@torch.library.custom_op("betacores_torch::multiclass_projection", mutates_args=())
def _mc_projection_op(z: torch.Tensor, thetas: torch.Tensor, n_classes: int, beta: float,
                      beta_t: Optional[torch.Tensor], use_beta: bool) -> torch.Tensor:
    """K2 as a functional op: beta is ``beta_t`` when given (a tensor of one
    element), else the float ``beta``. The CPU kernel is the plain version,
    the CUDA kernel the launch; a device without a kernel raises."""
    raise NotImplementedError(f"no kernel for device {z.device}")


@_mc_projection_op.register_kernel("cpu")
def _(z, thetas, n_classes, beta, beta_t, use_beta):
    return multiclass_projection_plain(z, thetas, n_classes,
                                       beta if beta_t is None else beta_t, use_beta)


@_mc_projection_op.register_kernel("cuda")
def _(z, thetas, n_classes, beta, beta_t, use_beta):
    _check_mc_operands(z, thetas, n_classes)
    N, D1 = z.shape
    d, K, S = D1 - 1, n_classes, thetas.shape[0]
    lib = _mc_lib()
    limit = torch.cuda.get_device_properties(z.device).shared_memory_per_block_optin
    _check_smem("projection", mc_plan_built(d, K, S, limit).smem, z.device,
                f"d={d}, K={K}, S={S}")
    if beta_t is not None:
        if beta_t.numel() != 1 or beta_t.device != z.device:
            raise ValueError(f"beta must be one element on {z.device}")
        beta_t = beta_t.reshape(1).to(torch.float32)
    else:
        beta_t = torch.full((1,), beta, dtype=torch.float32, device=z.device)
    out = torch.empty((N, S), dtype=torch.float32, device=z.device)
    if N == 0 or S == 0:
        return out
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.multiclass_projection(z.data_ptr(), thetas.data_ptr(),
                                       beta_t.data_ptr(), out.data_ptr(), N, d, K,
                                       S, int(use_beta), stream)
    if rc != 0:
        raise RuntimeError(f"multiclass_projection launch failed: cudaError {rc}")
    multiclass_projection.launches += 1
    return out


@_mc_projection_op.register_fake
def _(z, thetas, n_classes, beta, beta_t, use_beta):
    return z.new_empty((z.shape[0], thetas.shape[0]))


counted(multiclass_projection)


# ---------------------------------------------------------------------------
# K3: the shard-local partials of one sharded refinement step
# ---------------------------------------------------------------------------

def logreg_shard_step_partials_plain(xin, z, mu, linv, w_row, sc, s_true: int,
                                     use_beta: bool = False):
    """(colsum, core, corerow, wcore) of ``logreg_shard_step_partials`` in
    plain PyTorch: theta = z[:s_true] @ L^-1 + mu, the (beta-)log-likelihoods
    of the packed rows less each row's own at the mode mu, times the row
    mask, the sample columns from s_true to z's row count zero."""
    from ..models import logreg

    d = xin.shape[1] - 1
    M_pad = w_row.shape[1]
    n_sub_pad = xin.shape[0] - M_pad
    th = z[:s_true] @ linv + mu                                   # (s_true, d)
    x, msk = xin[:, :d], xin[:, d:]
    lik = ((lambda t: logreg.beta_likelihood(x, t, sc[0])) if use_beta
           else (lambda t: logreg.log_likelihood(x, t)))
    vals = F.pad((lik(th) - lik(mu)) * msk, (0, z.shape[0] - s_true))   # (R, s_pad)
    sub, core = vals[:n_sub_pad], vals[n_sub_pad:]
    return (sub.sum(dim=0, keepdim=True), core, core.sum(dim=1)[None, :],
            w_row @ core)


@functools.cache
def _shard_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("logreg_shard_partials")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.logreg_shard_partials.argtypes = [vp] * 10 + [ci] * 7 + [vp]
    lib.logreg_shard_partials.restype = ci
    lib.logreg_shard_partials_smem_bytes.argtypes = [ci] * 5
    lib.logreg_shard_partials_smem_bytes.restype = ctypes.c_longlong
    lib.logreg_shard_partials_floor.argtypes = [ci] * 5 + [vp]
    lib.logreg_shard_partials_floor.restype = ci
    return lib


def _check_shard_operands(xin, z, mu, linv, w_row, sc, s_true):
    R, D1 = xin.shape
    d, M_pad = D1 - 1, w_row.shape[-1]
    _check_tensors({"xin": (R, D1), "z": (z.shape[0], d), "mu": (1, d),
                    "linv": (d, d), "w_row": (1, M_pad), "sc": (1,)},
                   xin=xin, z=z, mu=mu, linv=linv, w_row=w_row, sc=sc)
    _check_step_layout(R, z.shape[0], M_pad, s_true)


def logreg_shard_step_partials(xin, z, mu, linv, w_row, sc, s_true: int,
                               use_beta: bool = False):
    """(colsum (1, s_pad), core (M_pad, s_pad), corerow (1, M_pad),
    wcore (1, s_pad)) of one sharded refinement step's shard-local work in
    ONE launch.

    Operands (float32, contiguous, on one device): xin (n_sub_pad + M_pad,
    d+1) rows [x | mask], subsample rows first; z (s_pad >= s_true, d) this
    shard's pre-drawn noise columns (rows from s_true on are ignored);
    mu (1, d) and linv (d, d) of the current Laplace fit; w_row (1, M_pad);
    sc = [beta]. Each row's value is its (beta-)log-likelihood less that
    row's own at mu: a constant per row, which drops out of the values
    centred over the sample axis, so the sharded builder's uncentred
    identity holds exactly, while the sums no longer carry the rows' common
    level (N / n times a row's likelihood once scaled), whose float32
    rounding would swamp the spread over samples. colsum sums the subsample
    rows, core is the buffer block, corerow its row sums and wcore =
    w_row @ core; columns from s_true on are 0."""
    if xin.device.type == "cpu":
        return logreg_shard_step_partials_plain(xin, z, mu, linv, w_row, sc,
                                                s_true, use_beta)
    if xin.device.type != "cuda":
        raise ValueError(f"no kernel for device {xin.device}")
    out = launch_shard_partials(xin, z, mu, linv, w_row, sc, s_true, use_beta,
                                cluster_size(xin.shape[0]))
    logreg_shard_step_partials.launches += 1
    return out


def launch_shard_partials(xin, z, mu, linv, w_row, sc, s_true: int, use_beta: bool,
                          cluster: int):
    """K3's launch as one cluster of ``cluster`` CTAs on CUDA operands,
    uncounted: ``logreg_shard_step_partials`` with the cluster size given,
    for measuring each size on the card."""
    _check_shard_operands(xin, z, mu, linv, w_row, sc, s_true)
    R, D1 = xin.shape
    s_pad, M_pad = z.shape[0], w_row.shape[1]
    lib = _shard_lib()
    _check_smem("shard step",
                lib.logreg_shard_partials_smem_bytes(R, D1 - 1, s_true, M_pad, cluster),
                xin.device, f"R={R}, M_pad={M_pad}, S={s_true}, d={D1 - 1}, C={cluster}")
    f32 = dict(dtype=torch.float32, device=xin.device)
    colsum, wcore = torch.empty((1, s_pad), **f32), torch.empty((1, s_pad), **f32)
    core, corerow = torch.empty((M_pad, s_pad), **f32), torch.empty((1, M_pad), **f32)
    with torch.cuda.device(xin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.logreg_shard_partials(
            xin.data_ptr(), z.data_ptr(), mu.data_ptr(), linv.data_ptr(),
            w_row.data_ptr(), sc.data_ptr(), colsum.data_ptr(), core.data_ptr(),
            corerow.data_ptr(), wcore.data_ptr(), R, D1 - 1, s_true, s_pad, M_pad,
            int(use_beta), cluster, stream)
    if rc != 0:
        raise RuntimeError(f"logreg_shard_partials launch of a {cluster}-CTA cluster "
                           f"failed: cudaError {rc}")
    return colsum, core, corerow, wcore


counted(logreg_shard_step_partials)


# ---------------------------------------------------------------------------
# Operand packing for the fused step, done once per refinement pass, outside
# the step loop. The layout is the reference's (subsample padded to 8 rows,
# coreset buffer to 128 slots, samples to 128), so the packed operands equal
# the reference's exactly; the kernel skips the padding.
# ---------------------------------------------------------------------------

def pack_fused_step_rows(rows_all, core_pts, slot_mask, n_sub: int, sub_mask=None,
                         out=None):
    """The (T, R, D+1) xin block: [subsample rows; zero pad to 8; coreset
    buffer; zero pad to 128] with the row mask as the last column
    (``sub_mask`` for subsample rows, slot_mask for buffer rows, 0 for
    padding). ``sub_mask`` is 1 by default; the sharded build passes a 0-d
    tensor that is 0 when its shard has no valid rows. ``out`` is a block
    this function made for the same shapes (its padding is still 0): the
    rows are written into it in place of a new one.

    Returns (xin_all, M_pad, R)."""
    T, _, D = rows_all.shape
    M_buf = core_pts.shape[0]
    n_sub_pad, M_pad = _round_up(n_sub, 8), _round_up(M_buf, 128)
    R = n_sub_pad + M_pad
    xin = out
    if xin is None:
        xin = torch.zeros((T, R, D + 1), dtype=torch.float32, device=rows_all.device)
    elif tuple(xin.shape) != (T, R, D + 1):
        raise ValueError(f"out has shape {tuple(xin.shape)}, want {(T, R, D + 1)}")
    xin[:, :n_sub, :D] = rows_all
    if sub_mask is None:
        xin[:, :n_sub, D].fill_(1.0)    # no tensor constant: a traced program holds this
    else:
        xin[:, :n_sub, D] = sub_mask
    xin[:, n_sub_pad:n_sub_pad + M_buf, :D] = core_pts
    xin[:, n_sub_pad:n_sub_pad + M_buf, D] = slot_mask.to(torch.float32)
    return xin, M_pad, R


def pad_fused_step_noise(z_all, s_active: int, out=None):
    """Pad the (T, S, d) pre-drawn noise block's sample axis to 128, into
    ``out`` when given (a block this function made for the same shapes)."""
    T, _, d = z_all.shape
    shape = (T, _round_up(s_active, 128), d)
    z = out
    if z is None:
        z = torch.zeros(shape, dtype=torch.float32, device=z_all.device)
    elif tuple(z.shape) != shape:
        raise ValueError(f"out has shape {tuple(z.shape)}, want {shape}")
    z[:, :s_active] = z_all
    return z


def adam_sclr_stack(step_sizes):
    """Per-step [lr, 1-b1^t, 1-b2^t] (t = 1..T) in float32, on the device of
    ``step_sizes``, with the bias corrections of
    utils/opt.py::adam_bias_corrections (the reference's float32 values bit
    for bit for t < 2958). Builders call this once, not per refinement
    pass."""
    bc = adam_bias_corrections(step_sizes.shape[0], torch.float32,
                               step_sizes.device, ADAM_B1, ADAM_B2)
    return torch.cat([step_sizes.to(torch.float32)[:, None], bc], dim=1)  # (T, 3)


def make_refit_state(smp, pts):
    """refit_state(w, lap_aux) -> (lap, L^-1 as float32), through the
    sampler's fit_inv when it has one (the Newton direction is computed
    through L^-1, so the step gets it without a separate inversion), else
    through ``fit`` and a triangular solve of the float32 factor."""
    fit_inv = getattr(smp, "fit_inv", None)

    def refit_state(w, lap_aux):
        if fit_inv is not None:
            lap = fit_inv(w, pts, lap_aux)
            return lap, lap.prec_chol_inv.to(torch.float32).contiguous()
        lap = smp.fit(w, pts, lap_aux)
        L = lap.prec_chol.to(torch.float32)
        eye = identity(L.shape[0], torch.float32, L.device)
        return lap, torch.linalg.solve_triangular(L, eye, upper=False).contiguous()

    return refit_state


class FusedPass:
    """The static buffers of a fused-route refinement pass (K1's, or K3's
    on a mesh) and the parts of its step that the two builders share.

    Everything a step reads or carries lives here at a fixed address, so
    that the step body can be captured once as a CUDA graph and replayed
    (utils/graphs.py): the packed rows ``xin_all`` (T, R, D+1) and noise
    ``z_pad`` (T, s_pad, d) of the whole pass, the buffer's points, ``sc``
    = [beta, *sc_tail], the Adam carry ``w``, ``m1``, ``m2`` (1, M_pad), the
    Laplace fit the kernel consumes (``mu`` (1, d) and ``linv`` (d, d) in
    float32), the sampler's warm start ``aux``, and the step counter ``i``
    (on the device: a replayed step picks its own rows, noise and Adam
    scalars). ``fill`` copies one selection's state and draws in; nothing
    is reallocated between selections.

    With lagged refits (``k_refit`` > 1) the Newton chain runs before the
    pass and then on every k-th step (step 0 reuses the fit made before
    the pass); otherwise on every step. That schedule is the host's
    (``refits``), so it costs no device read."""

    def __init__(self, sampler, st, z_all, n_sub: int, s_active: int, sclr_all, sc_tail,
                 k_refit: int, w_dtype: torch.dtype, runner):
        f32 = dict(dtype=torch.float32, device=st.pts.device)
        T, _, d = z_all.shape
        self.M_buf, D = st.pts.shape
        self.n_sub, self.s_active, self.n_steps = n_sub, s_active, T
        self.k_refit, self.w_dtype, self.runner = k_refit, w_dtype, runner
        self.M_pad = _round_up(self.M_buf, 128)
        self.xin_all = torch.zeros((T, _round_up(n_sub, 8) + self.M_pad, D + 1), **f32)
        self.z_pad = torch.zeros((T, _round_up(s_active, 128), d), **f32)
        self.sclr_all = sclr_all
        self.sc = torch.zeros(1 + sc_tail.numel(), **f32)
        self.sc[1:] = sc_tail
        self.pts, self.wts0 = torch.empty_like(st.pts), torch.empty_like(st.wts)
        # the warm start in the dtype the fit computes in (its mode's)
        fit_dtype = torch.promote_types(torch.promote_types(st.wts.dtype, st.pts.dtype),
                                        st.sampler_aux.dtype)
        self.aux = torch.empty_like(st.sampler_aux, dtype=fit_dtype)
        self.mu, self.linv = torch.empty((1, d), **f32), torch.empty((d, d), **f32)
        self.w, self.m1, self.m2 = (torch.zeros((1, self.M_pad), **f32) for _ in range(3))
        self.i = torch.zeros(1, dtype=torch.int64, device=st.pts.device)
        self.refit_state = make_refit_state(sampler, self.pts)
        self.fit_aux = sampler.fit_aux
        self.like = signature((st.pts, st.wts, st.sampler_aux, z_all))

    def serves(self, st, z_all) -> bool:
        """Whether these buffers fit this state and these draws."""
        return self.like == signature((st.pts, st.wts, st.sampler_aux, z_all))

    def fill(self, rows_all, st, z_all, sub_mask=None) -> None:
        """One selection's state and draws into the buffers; the Adam
        moments and the step counter back to 0."""
        pack_fused_step_rows(rows_all, st.pts, st.slot_mask, self.n_sub, sub_mask,
                             out=self.xin_all)
        pad_fused_step_noise(z_all, self.s_active, out=self.z_pad)
        self.sc[:1].copy_(st.beta.reshape(1))
        self.pts.copy_(st.pts)
        self.wts0.copy_(st.wts)
        self.aux.copy_(st.sampler_aux)
        self.w.zero_()
        self.w[0, :self.M_buf].copy_(st.wts)
        self.m1.zero_()
        self.m2.zero_()
        self.i.zero_()

    def refits(self, i: int) -> bool:
        """Whether step i runs the Newton chain."""
        return self.k_refit == 1 or (i % self.k_refit == 0 and i > 0)

    def refit(self, first: bool = False) -> None:
        """The Newton refit at the current weights (``first``: at the
        selection's own weights, before the pass), warm-started at ``aux``,
        into ``aux``, ``mu`` and ``linv``."""
        w = self.wts0 if first else self.w[0, :self.M_buf].to(self.w_dtype)
        lap, linv = self.refit_state(w, self.aux)
        self.aux.copy_(self.fit_aux(lap))
        self.mu[0].copy_(lap.mu)
        self.linv.copy_(linv)

    def step_operands(self):
        """(xin, z, sclr) of the step the device counter points at."""
        return (self.xin_all.index_select(0, self.i)[0],
                self.z_pad.index_select(0, self.i)[0],
                self.sclr_all.index_select(0, self.i)[0])

    def advance(self, w, m1, m2) -> None:
        """The step's Adam state into the carry, and on to the next step.
        The kernels write fresh outputs, which under replay sit at fixed
        addresses of their own: without this copy the next step would read
        the state of two steps before."""
        self.w.copy_(w)
        self.m1.copy_(m1)
        self.m2.copy_(m2)
        self.i.add_(1)

    def run(self, step) -> None:
        """The whole pass: ``step(refit)`` for every step of the schedule."""
        if self.k_refit > 1:
            self.runner.run("first fit", lambda: self.refit(first=True))
        self.runner.run_pass(self.n_steps, step, self.refits)

    def result(self, st):
        """``st`` with the refined weights and the last fit's warm start,
        as tensors of their own (the buffers are reused)."""
        return st._replace(wts=self.w[0, :self.M_buf].to(st.wts.dtype, copy=True),
                           sampler_aux=self.aux.clone())
