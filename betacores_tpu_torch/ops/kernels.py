"""The port's hand-written kernels and their operand packers (counterpart of
betacores_tpu/ops/pallas_kernels.py).

``logreg_adam_step`` is one whole projected-Adam refinement step of the
incremental build in one launch (CUDA C++, csrc/logreg_adam_step.cu). On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
``logreg_adam_step_plain``, the same function in plain PyTorch, which the
CPU tests and the on-card comparison use. There is no fallback between the
two. ``logreg_adam_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models import logreg
from .projection import center

# MUST match utils/opt.py::nn_adam of the reference (b1, b2, eps); the
# CUDA source repeats them
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def logreg_adam_step_plain(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true: int,
                           use_beta: bool = False):
    """(w', m1', m2') of one projected-Adam refinement step, in plain
    PyTorch, on the operands of ``logreg_adam_step``. Padding of any size
    is allowed: padded sample rows of ``z`` are sliced off, padded rows of
    ``xin`` carry mask 0, padded Adam slots have zero core rows."""
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
    lib.logreg_adam_step.argtypes = [vp] * 12 + [ci] * 5 + [vp]
    lib.logreg_adam_step.restype = ci
    lib.logreg_adam_step_smem_bytes.argtypes = [ci, ci, ci]
    lib.logreg_adam_step_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check_operands(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true):
    R, D1 = xin.shape
    d, M_pad = D1 - 1, w.shape[-1]
    want = {"xin": (R, D1), "z": (z.shape[0], d), "mu": (1, d), "linv": (d, d),
            "w": (1, M_pad), "m1": (1, M_pad), "m2": (1, M_pad), "sc": (2,),
            "sclr": (3,)}
    ops = dict(xin=xin, z=z, mu=mu, linv=linv, w=w, m1=m1, m2=m2, sc=sc, sclr=sclr)
    for name, t in ops.items():
        if t.device != xin.device:
            raise ValueError(f"{name} on {t.device}, xin on {xin.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= s_true <= z.shape[0]:
        raise ValueError(f"s_true={s_true} outside [1, {z.shape[0]}]")
    if not 1 <= M_pad <= R:
        raise ValueError(f"M_pad={M_pad} outside [1, R={R}]")


def logreg_adam_step(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true: int,
                     use_beta: bool = False):
    """(w', m1', m2') of one projected-Adam refinement step in ONE launch.

    Operands (float32, contiguous, on one device): xin (n_sub_pad + M_pad,
    d+1) rows [x | mask], subsample rows first; z (s_pad >= s_true, d)
    pre-drawn noise; mu (1, d) and linv (d, d) = L^-1 of the current Laplace
    fit (theta = mu + z @ L^-1); w, m1, m2 (1, M_pad) Adam state;
    sc = [beta, sum_scaling]; sclr = [lr, 1-b1^t, 1-b2^t]."""
    if xin.device.type == "cpu":
        return logreg_adam_step_plain(xin, z, mu, linv, w, m1, m2, sc, sclr,
                                      s_true, use_beta)
    if xin.device.type != "cuda":
        raise ValueError(f"no kernel for device {xin.device}")
    _check_operands(xin, z, mu, linv, w, m1, m2, sc, sclr, s_true)
    R, D1 = xin.shape
    M_pad = w.shape[1]
    lib = _lib()
    smem = lib.logreg_adam_step_smem_bytes(D1 - 1, s_true, M_pad)
    limit = torch.cuda.get_device_properties(xin.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"step needs {smem} B of shared memory, the card "
                         f"allows {limit} B per block (M_pad={M_pad}, "
                         f"S={s_true}, d={D1 - 1})")
    w_out, m1_out, m2_out = (torch.empty_like(w) for _ in range(3))
    with torch.cuda.device(xin.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.logreg_adam_step(
            xin.data_ptr(), z.data_ptr(), mu.data_ptr(), linv.data_ptr(),
            w.data_ptr(), m1.data_ptr(), m2.data_ptr(), sc.data_ptr(),
            sclr.data_ptr(), w_out.data_ptr(), m1_out.data_ptr(),
            m2_out.data_ptr(), R, D1 - 1, s_true, M_pad, int(use_beta), stream)
    if rc != 0:
        raise RuntimeError(f"logreg_adam_step launch failed: cudaError {rc}")
    logreg_adam_step.launches += 1
    return w_out, m1_out, m2_out


logreg_adam_step.launches = 0


# ---------------------------------------------------------------------------
# Operand packing for the fused step, done once per refinement pass, outside
# the step loop. The layout is the reference's (subsample padded to 8 rows,
# coreset buffer to 128 slots, samples to 128), so the packed operands equal
# the reference's exactly; the kernel skips the padding.
# ---------------------------------------------------------------------------

def pack_fused_step_rows(rows_all, core_pts, slot_mask, n_sub: int):
    """The (T, R, D+1) xin block: [subsample rows; zero pad to 8; coreset
    buffer; zero pad to 128] with the row mask as the last column (1 for
    subsample rows, slot_mask for buffer rows, 0 for padding).

    Returns (xin_all, M_pad, R)."""
    T, _, D = rows_all.shape
    M_buf = core_pts.shape[0]
    n_sub_pad, M_pad = _round_up(n_sub, 8), _round_up(M_buf, 128)
    R = n_sub_pad + M_pad
    xin = torch.zeros((T, R, D + 1), dtype=torch.float32, device=rows_all.device)
    xin[:, :n_sub, :D] = rows_all
    xin[:, :n_sub, D] = 1.0
    xin[:, n_sub_pad:n_sub_pad + M_buf, :D] = core_pts
    xin[:, n_sub_pad:n_sub_pad + M_buf, D] = slot_mask.to(torch.float32)
    return xin, M_pad, R


def pad_fused_step_noise(z_all, s_active: int):
    """Pad the (T, S, d) pre-drawn noise block's sample axis to 128."""
    T, _, d = z_all.shape
    z = torch.zeros((T, _round_up(s_active, 128), d), dtype=torch.float32,
                    device=z_all.device)
    z[:, :s_active] = z_all
    return z


def adam_sclr_stack(step_sizes):
    """Per-step [lr, 1-b1^t, 1-b2^t] (t = 1..T) in float32, on the device of
    ``step_sizes``. The reference raises the float32 constants to float32
    powers with libm's powf; torch's float32 pow rounds differently in a
    few steps, so the powers are formed on the host in float64 and rounded
    once to float32, which reproduces the reference's values bit for bit
    for t < 2958 (at t = 2958 and 3606 the two round 0.999^t apart by one
    ulp). Builders call this once, not per refinement pass."""
    t = np.arange(1, step_sizes.shape[0] + 1, dtype=np.float64)
    bc = [np.float32(1.0) - (np.float64(np.float32(b)) ** t).astype(np.float32)
          for b in (ADAM_B1, ADAM_B2)]
    bc = torch.from_numpy(np.stack(bc, axis=1)).to(step_sizes.device)
    return torch.cat([step_sizes.to(torch.float32)[:, None], bc], dim=1)  # (T, 3)


def make_refit_state(smp, pts):
    """refit_state(w, lap_aux) -> (lap, L^-1 as float32), through the
    sampler's fit_inv (the Newton direction is computed through L^-1, so
    the step gets it without a separate inversion)."""
    def refit_state(w, lap_aux):
        lap = smp.fit_inv(w, pts, lap_aux)
        return lap, lap.prec_chol_inv.to(torch.float32).contiguous()

    return refit_state


def make_step_refit(refit_state, lagged: bool, k_refit: int, fit_aux,
                    M_buf: int, w_dtype):
    """Per-step (lap, L^-1): with lagged refits the Newton chain runs only
    on every k-th step (step 0 reuses the fit made before the loop);
    otherwise every step refits. The step index is a host int, so the
    schedule costs no device read."""
    def step_refit(w, i: int, lap_c):
        if not lagged:
            return refit_state(w[0, :M_buf].to(w_dtype), lap_c)
        if i % k_refit == 0 and i > 0:
            return refit_state(w[0, :M_buf].to(w_dtype), fit_aux(lap_c[0]))
        return lap_c

    return step_refit
