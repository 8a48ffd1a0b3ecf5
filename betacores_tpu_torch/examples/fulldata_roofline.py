"""Full-candidate (n_subsample=None) builds at headline scale, with roofline
accounting, through the port (counterpart of examples/fulldata_roofline.py).

The reference's DEFAULT semantics score ALL N candidates every selection
(reference bayesiancoresets/coreset/sparsevi.py:14-15: ``n_subsample=None``
unless the caller subsamples), and its exact-gradient mode sums over all N
every optimization step. Unlike the subsampled headline config (a
latency-bound chain of small dependent kernels), these are (N, S) passes
whose bytes and operations the card's peaks bound.

Configs measured end to end on one device (N=1M contaminated logreg rows,
d=10, M=100 selections, S=100):

  headline  n_sel=1000, n_opt=200, 500 Adam itrs   (control; bench_torch.py config)
  fullsel   n_sel=None, n_opt=200, 500 Adam itrs   (reference default select)
  fullopt   n_sel=None, n_opt=None, 50 Adam itrs   (exact Sigma-over-N gradient)

For each config this prints wall clock plus an analytic roofline: the
mandatory device-memory bytes and float32 operations of the (N, S) passes,
and the achieved fraction of the card's peaks (67 TFLOP/s float32 and
3.35 TB/s, examples/_common.py, as chip_smoke.py states its kernels'
bounds), beside the card's name and power limit. Two memory floors are
reported for the select pass: the MATERIALIZING floor (write + re-read the
(N, S) projection, which eager PyTorch does) and the STREAMING floor (read
the 40 MB dataset twice, recompute the projection in the second pass).

Timing: a first build (its passes captured as CUDA graphs) and
``--repeats`` more, each on a host clock around synchronised work.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from betacores_tpu_torch.examples._common import (PEAK_BW, PEAK_FLOPS, add_port_flags,
                                                   device_line, keyed, sync)

N, D_FEAT, M, S = 1_000_000, 10, 100, 100   # defaults; --n/--d override
M_BUF = 128


def _roofline(name, t, n_full_sel, n_full_opt, opt_itrs, card):
    """Floors of the (N, S) passes (module globals N, D_FEAT, M, S): the
    select pass has two consumer reads of the materialised projection
    (column sums, then row scores once the residual exists), the optimize
    pass one; the streaming floor is what a kernel that never materialises
    (N, S) would move."""
    d = D_FEAT
    row_bytes = N * d * 4
    ns_bytes = N * S * 4
    sel_flops = 2 * N * d * S + 4 * N * S          # proj matmul + score matvecs
    opt_flops = 2 * N * d * S + 2 * N * S          # proj matmul + column sum

    n_steps = M * opt_itrs
    flops = n_full_sel * sel_flops + (opt_flops * n_steps if n_full_opt else 0)
    bytes_mat = (n_full_sel * (row_bytes + 3 * ns_bytes)
                 + ((row_bytes + 2 * ns_bytes) * n_steps if n_full_opt else 0))
    bytes_stream = (n_full_sel * 2 * row_bytes
                    + (row_bytes * n_steps if n_full_opt else 0))
    floors = {
        "flop_s": flops / PEAK_FLOPS,
        "mem_mat_s": bytes_mat / PEAK_BW,
        "mem_stream_s": bytes_stream / PEAK_BW,
    }
    print(
        f"[{name}] wall {t:.3f}s | analytic floors: "
        f"FLOP {floors['flop_s']*1e3:.2f} ms, "
        f"memory(materialised) {floors['mem_mat_s']*1e3:.2f} ms, "
        f"memory(streaming) {floors['mem_stream_s']*1e3:.2f} ms | achieved "
        f"{100*flops/(t*PEAK_FLOPS):.3f}% of float32 peak, "
        f"{100*bytes_mat/(t*PEAK_BW):.2f}% of memory peak (materialised), "
        f"{100*bytes_stream/(t*PEAK_BW):.2f}% (streaming) on {card}",
        file=sys.stderr,
    )
    return floors


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*",
                    default=["headline", "fullsel", "fullopt"])
    ap.add_argument("--fullopt-itrs", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--d", type=int, default=D_FEAT)
    ap.add_argument("--quality", action="store_true",
                    help="also score each config's FINAL coreset downstream: "
                         "Laplace posterior on the coreset -> held-out "
                         "accuracy / predictive log-likelihood on 20k clean "
                         "rows, plus the shared-draw tangent error")
    add_port_flags(ap)
    return ap


def main(argv=None):
    """Prints the JSON record of every config; returns it."""
    global N, D_FEAT
    args = parser().parse_args(argv)
    N, D_FEAT = args.n, args.d
    dev = args.device

    from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                              make_incremental_builder)
    from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.models import logreg

    card = device_line(dev)
    print(f"device: {card}", file=sys.stderr)
    g = keyed(args, 0)
    X, y, _ = gen_synthetic_logreg(g, N, d=D_FEAT, dtype=torch.float32)
    _, _, Z, _ = perturb_logreg(g, X, y, f_rate=0.1)
    del X, y
    if args.quality:
        from betacores_tpu_torch.coresets.incremental import make_tangent_error
        from betacores_tpu_torch.inference import newton_laplace, sample_laplace_from_noise

        # clean held-out rows from the same generator (no corruption)
        Xt, yt, Zt = gen_synthetic_logreg(keyed(args, 7), 20_000, d=D_FEAT,
                                          dtype=torch.float32)
        # ONE shared FULL-DATA tangent-error estimator for every config:
        # each builder's own error() uses its config's n_subsample_opt, and
        # a subsampled estimate is inflated by estimator variance
        shared_err = None

        def _quality(wts, pts, slot_mask):
            wm = wts * slot_mask
            lap = newton_laplace(
                lambda th: logreg.log_joint(pts, th, wm),
                lambda th: logreg.grad_th_log_joint(pts, th, wm),
                lambda th: logreg.hess_th_log_joint(pts, th, wm),
                torch.zeros(pts.shape[1], dtype=torch.float32, device=dev), n_iters=25)
            ths = sample_laplace_from_noise(
                lap, torch.randn((256, pts.shape[1]), generator=keyed(args, 9),
                                 dtype=torch.float32, device=dev))
            return (logreg.compute_accuracy(Xt, yt, ths), logreg.predictive_loglik(Zt, ths))

    cfg_by_name = {
        "headline": IncrementalConfig(projection_dim=S, n_subsample_select=1000,
                                      n_subsample_opt=200, opt_itrs=500, i0=1.0,
                                      use_beta=True),
        "fullsel": IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                     n_subsample_opt=200, opt_itrs=500, i0=1.0,
                                     use_beta=True),
        "fullopt": IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                     n_subsample_opt=None,
                                     opt_itrs=args.fullopt_itrs, i0=1.0,
                                     use_beta=True),
    }
    model = logreg.bundle()
    sampler = logreg_laplace_sampler()
    st0 = init_state(M_BUF, D_FEAT, beta=0.1, dtype=torch.float32, device=dev)

    def timed_build(builder):
        sync(dev)
        t0 = time.perf_counter()
        st = builder.build(st0, M, builder.generator_draws(keyed(args, 2)))
        m_sel = int(st.m)  # a host read: waits for the build
        return st, m_sel, time.perf_counter() - t0

    out = {}
    for name in args.configs:
        cfg = cfg_by_name[name]
        builder = make_incremental_builder(Z, model, sampler, cfg)
        st, m_sel, t_first = timed_build(builder)
        times = []
        for _ in range(args.repeats):
            st, m_sel, t = timed_build(builder)
            times.append(t)
        t = min(times) if times else t_first
        wsum = float(st.wts.sum())
        print(f"[{name}] first(incl capture) {t_first:.1f}s; runs "
              f"{['%.3f' % x for x in times]}; m={m_sel} sum(w)={wsum:.1f}",
              file=sys.stderr)
        floors = _roofline(name, t,
                           n_full_sel=(M if cfg.n_subsample_select is None else 0),
                           n_full_opt=cfg.n_subsample_opt is None,
                           opt_itrs=cfg.opt_itrs, card=card)
        out[name] = {"wall_s": round(t, 3), "m": m_sel,
                     "sum_w": round(wsum, 1), "opt_itrs": cfg.opt_itrs,
                     **{k: round(v, 4) for k, v in floors.items()}}
        if args.quality:
            if shared_err is None:
                shared_err = make_tangent_error(
                    Z, model, sampler,
                    IncrementalConfig(projection_dim=S, n_subsample_opt=None,
                                      use_beta=True))
            err = float(shared_err(st, keyed(args, 123)))
            acc, pll = _quality(st.wts, st.pts, st.slot_mask.to(torch.float32))
            acc, pll = float(acc), float(pll)
            print(f"[{name}] quality: tangent err {err:.1f} (shared draws), "
                  f"held-out acc {acc:.4f}, pll {pll:.4f}", file=sys.stderr)
            out[name].update(tangent_err=round(err, 2), acc=round(acc, 4),
                             pll=round(pll, 4))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
