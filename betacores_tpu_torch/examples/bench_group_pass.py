"""Group-mode build microbenchmarks, through the port (counterpart of
examples/bench_group_pass.py).

The group build's per-step cost is one full (N, S) projection followed by a
(G, S) group reduction (select) or a total over groups (optimize). This
script measures, at movielens-groups scale and a larger webspam-like shape:

  proj      projection + plain column sum (the streaming floor)
  segsum    projection + scatter-add group reduction (index_add_)
  onehot    projection + one-hot matmul group reduction
  opt_old   scatter-add group reduction summed over groups
  opt_new   masked weighted column sum

Timing as in bench_select_pass.py: CUDA events around ``--reps`` calls on
fresh theta blocks. ``--end-to-end`` runs the real group builder
(coresets/groups.py, reference group semantics: full group select + exact
gradient) instead, a warm-up build and a timed one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
from betacores_tpu_torch.examples._common import add_port_flags, device_line, keyed, sync
from betacores_tpu_torch.examples.bench_select_pass import timed_passes
from betacores_tpu_torch.models import logreg


def _rows(args, N, d):
    g = keyed(args, 0)
    X, y, _ = gen_synthetic_logreg(g, N, d=d, dtype=torch.float32)
    return perturb_logreg(g, X, y, f_rate=0.1)[2]


def run_shape(args, N, G, S, d, reps):
    dev = args.device
    Z = _rows(args, N, d)
    D = Z.shape[1]
    beta = 0.1
    ths = torch.randn((reps, S, D), generator=keyed(args, 2), dtype=torch.float32,
                      device=dev) * 0.1
    # contiguous equal groups + a tail of ungrouped rows (id G)
    per = N // (G + 1)
    gid = torch.clamp_max(torch.arange(N, device=dev) // max(per, 1), G)
    ones = torch.ones((S,), dtype=torch.float32, device=dev)

    def blik(pts, th):
        v = logreg.beta_likelihood(pts, th, beta)
        return v - v.mean(dim=1, keepdim=True)

    def segment_sum(v, gid):
        return torch.zeros((G + 1, v.shape[1]), dtype=v.dtype, device=v.device).index_add_(
            0, gid, v)[:G]

    def v_proj(Z, gid, th):
        return blik(Z, th).sum(dim=0) @ ones

    def v_segsum(Z, gid, th):
        return segment_sum(blik(Z, th), gid).sum()

    def v_onehot(Z, gid, th):
        onehot = (gid[:, None] == torch.arange(G, device=gid.device)).to(Z.dtype)
        return (onehot.T @ blik(Z, th)).sum()

    def v_opt_old(Z, gid, th):
        return segment_sum(blik(Z, th), gid).sum(dim=0) @ ones

    def v_opt_new(Z, gid, th):
        w_eff = (gid < G).to(torch.float32)
        return (w_eff @ blik(Z, th)) @ ones

    out = {}
    for name, body in [("proj", v_proj), ("segsum", v_segsum),
                       ("onehot", v_onehot), ("opt_old", v_opt_old),
                       ("opt_new", v_opt_new)]:
        per_s, r, _ = timed_passes(body, (Z, gid), ths, dev)
        out[name] = per_s * 1e3
        print(f"  {name:8s} {per_s * 1e3:8.3f} ms/pass  (acc={r:.4g})")
    return out


def run_end_to_end(args, N, G, S, d, M_groups, opt_itrs):
    """The REAL group builder (make_group_incremental_builder) at scale,
    reference group semantics (n_subsample_select=None — score every group;
    n_subsample_opt=None — exact gradient), end to end on the device."""
    from betacores_tpu_torch.coresets import IncrementalConfig, init_state
    from betacores_tpu_torch.coresets.groups import (init_group_state,
                                                    make_group_incremental_builder)
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.ops.projection import Groups

    dev = args.device
    Z = _rows(args, N, d)
    per = N // G
    gp = Groups.from_lists([range(g * per, min((g + 1) * per, N)) for g in range(G)], dev)
    cfg = IncrementalConfig(projection_dim=S, n_subsample_select=None,
                            n_subsample_opt=None, opt_itrs=opt_itrs, i0=1.0,
                            use_beta=True)
    build = make_group_incremental_builder(Z, gp, logreg.bundle(), logreg_laplace_sampler(),
                                           cfg)
    M_buf = (M_groups + 1) * per
    gst0 = init_group_state(init_state(M_buf, Z.shape[1], beta=0.1, dtype=torch.float32,
                                       device=dev), G)
    times = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        gst = build.build(gst0, M_groups, build.generator_draws(keyed(args, 2)))
        n_sel = int(gst.selected.sum())
        times.append(time.perf_counter() - t0)
    t_first, t = times
    per_iter = t / M_groups * 1e3
    print(f"  end-to-end: {t:.3f}s for {M_groups} group selections x "
          f"{opt_itrs} exact-gradient steps (first incl capture "
          f"{t_first:.1f}s); {n_sel} groups selected, m={int(gst.core.m)} "
          f"points; {per_iter:.1f} ms/iteration "
          f"~ {per_iter / (1 + opt_itrs):.3f} ms per (N, S) pass")
    return {"s": t, "ms_per_iteration": per_iter}


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--shapes", nargs="*",
                    default=["10000x100", "126185x500", "1000000x100"])
    ap.add_argument("--S", type=int, default=100)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--end-to-end", action="store_true",
                    help="run the real group builder (reference group "
                         "semantics: full group select + exact gradient) "
                         "instead of the per-pass microbenches")
    ap.add_argument("--M-groups", type=int, default=20)
    ap.add_argument("--opt-itrs", type=int, default=100)
    add_port_flags(ap)
    return ap


def main(argv=None):
    """Returns {shape: that shape's timings}."""
    args = parser().parse_args(argv)
    print(f"device: {device_line(args.device)}", file=sys.stderr)
    out = {}
    for shp in args.shapes:
        N, G = (int(v) for v in shp.split("x"))
        print(f"N={N} G={G} S={args.S} on {device_line(args.device)}:")
        if args.end_to_end:
            out[shp] = run_end_to_end(args, N, G, args.S, args.d, args.M_groups,
                                      args.opt_itrs)
        else:
            out[shp] = run_shape(args, N, G, args.S, args.d, args.reps)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
