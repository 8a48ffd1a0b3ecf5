"""The card's published peaks and the roofline bounds of the port's kernels.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.

``step_bound`` (K1), ``shard_bound`` (K3) and ``mc_bound`` (K2) are copied
from chip_smoke.py (the first two from its ``step_bound``, with the live
rows given as counts, not read off the operands): the least time the card
could take for one launch, the larger of the bytes it must move (each input
read once, each output written once) over the bandwidth and its float32
operations over the float32 peak.
"""

from __future__ import annotations

PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def _bound(flops: int, nbytes: int) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def step_bound(R: int, d: int, s_true: int, M_pad: int, n_live: int, n_core_live: int,
               transform_ops: int) -> dict:
    """One K1 launch (the fused projected-Adam step) on R packed rows of d
    features plus a mask, s_true samples, an M_pad-slot Adam state, of which
    n_live rows are live and n_core_live of them buffer rows. Operations:
    theta (2 S d^2); per live value the dot product, the transform and the
    mask and sums (2 d + transform_ops + 2); per live buffer value the
    centred gradient (4); the Adam update (12 a slot)."""
    flops = (2 * s_true * d * d + n_live * s_true * (2 * d + transform_ops + 2)
             + n_core_live * s_true * 4 + 12 * M_pad)
    nbytes = 4 * (R * (d + 1) + s_true * d + d + d * d) + 4 * (3 * M_pad + 5 + 3 * M_pad)
    return _bound(flops, nbytes)


def shard_bound(R: int, d: int, s_true: int, s_pad: int, M_pad: int, n_live: int,
                n_core_live: int, transform_ops: int) -> dict:
    """One K3 launch (a sharded refinement step's shard-local partials) on
    R packed rows of d features plus a mask, s_true samples in s_pad
    columns, an M_pad-slot buffer, of which n_live rows are live and
    n_core_live of them buffer rows. Operations: theta (2 S d^2); per live
    value the dot product, the transform and the mask and sums (2 d +
    transform_ops + 2); per live buffer value its row sum and the weighted
    sum (4). Bytes: the rows, noise, mu and L^-1, the weights and beta in;
    the column sum, the buffer block, its row sums and the weighted sum
    out."""
    flops = (2 * s_true * d * d + n_live * s_true * (2 * d + transform_ops + 2)
             + n_core_live * s_true * 4)
    nbytes = (4 * (R * (d + 1) + s_true * d + d + d * d)
              + 4 * (M_pad + 1 + 2 * s_pad + M_pad * s_pad + M_pad))
    return _bound(flops, nbytes)


def mc_bound(N: int, S_true: int, K: int, d: int, use_beta: bool) -> dict:
    """One K2 launch (the centred K-class projection) over N rows: z and
    the thetas read once, the (N, S) block written once; per value, per
    class the logit (2 d) and the softmax's max, exp and sum (3), with the
    β-likelihood the mass term's subtract, multiply, exp and add (4); then
    the log and the label pick (2), with β the exp of β lp_y and its scale
    (2), and the centring (2)."""
    per_value = K * (2 * d + 3 + (4 if use_beta else 0)) + 4 + (2 if use_beta else 0)
    flops = N * S_true * per_value
    nbytes = 4 * (N * (d + 1) + S_true * K * d + N * S_true + 1)
    return _bound(flops, nbytes)
