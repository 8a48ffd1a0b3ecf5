"""The headline configuration on a mesh: N=1M, M=100 sharded build, through
the port (counterpart of examples/virtual_mesh_headline.py).

Runs the full headline configuration (bench_torch.py: N=1M contaminated
logreg rows, M=100 selections x 500 Adam steps, S=100,
n_subsample_select=1000, n_subsample_opt=200) through
``make_sharded_incremental_builder`` on a ``data x samp`` mesh end to end.
Where the JAX driver forces a virtual 8-device CPU mesh in one process, the
port runs one process per rank: ``--device cpu`` spawns a gloo world of
D*S ranks on the CPU (the default 4x2 is 8 ranks); on cards it is an NCCL
world, one rank a card, so one card serves only ``--mesh 1x1`` (a world of
one in this process, where the sharded step's kernel K3 runs at every Adam
step) and any larger mesh raises, naming the card count. Every rank makes
the same rows from the same generator and keeps its shard.

``--census`` counts the collectives of ONE build iteration at tiny shapes
(N = 16 D + 3, S = 4 S_ax, 3 Adam steps), as the JAX driver counts the
collectives of its TPU-platform StableHLO. The port has no such lowering: it
counts the calls of ``Mesh.psum`` and ``Mesh.all_gather`` of rank 0, per
select and per Adam step. The design's counts (``CENSUS``), for every mesh
shape, samp axis of 1 included (the collectives run on an axis of size 1
too):
  * headline and full-select: a select is 3 psums (the projections' row
    sums over samp, the target over data, the scores' inner products over
    samp) and 1 all_gather (each data shard's top candidate packed with its
    score, index and row into one tensor); an Adam step of the fused route
    is 2 psums (the column sum over data; the packed core, corerow and wcore
    partials over both);
  * full-gradient: the same select; an Adam step of the exact-gradient
    route is 2 psums (the projections' row sums over samp, the residual's
    inner products over samp) plus the full-data target over data, 3 in all.
The reference's census counts the collective ops of the lowered program,
where the Adam steps' loop body appears once: at these shapes it reads 10
all_reduces and 3 all_gathers (headline, full-select) and 11 and 3
(full-gradient), on a 4x2 mesh and a 1x1 mesh alike. Where the port's
counts differ, by design: its select sends each data shard's candidate
(score, index and row packed into one tensor) in one all_gather where the
reference's program has three, and a learn_beta step packs its row sums and
then its inner products into three psums where the reference's has six
all_reduces (ROADMAP.md, deliberate deviations).

Run:  python -m betacores_tpu_torch.examples.virtual_mesh_headline [--mesh 4x2] [--itrs 100]
"""

import argparse
import collections
import sys
import time

import numpy as np
import torch

from betacores_tpu_torch.coresets import IncrementalConfig, init_state
from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
from betacores_tpu_torch.examples._common import (add_port_flags, device_line, keyed,
                                                   parse_mesh, seed_of, sync)
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg

D_FEAT, M_BUF, BETA = 10, 128, 0.1
# the census's collectives of rank 0: per select, per Adam step
CENSUS = {
    "headline": ({"psum": 3, "all_gather": 1}, {"psum": 2}),
    "full-select": ({"psum": 3, "all_gather": 1}, {"psum": 2}),
    "full-gradient": ({"psum": 3, "all_gather": 1}, {"psum": 3}),
}
CENSUS_ITRS = 3


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="4x2", help="data x samp mesh shape")
    ap.add_argument("--itrs", type=int, default=100, help="selections (M)")
    ap.add_argument("--n", type=int, default=1_000_000)
    # headline values by default; the smoke test shrinks them
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=500)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    # the FULL-DATA select config (reference default semantics,
    # n_subsample_select=None): every shard scores all its local rows, the
    # exact Sigma-over-N meets in one psum('data'), and the distributed
    # argmax runs over every valid row
    ap.add_argument("--full-data", action="store_true",
                    help="n_subsample_select=None (score ALL N per selection)")
    # the FULL-GRADIENT config: the reference's default semantics on BOTH
    # phases (n_subsample=None everywhere)
    ap.add_argument("--full-gradient", action="store_true",
                    help="n_subsample_select=None AND n_subsample_opt=None "
                         "(exact gradient; pair with --opt-itrs 50)")
    ap.add_argument("--census", action="store_true",
                    help="also run ONE build iteration of this config at tiny "
                         "shapes and print the collectives of its select and "
                         "of each Adam step (shape-independent)")
    add_port_flags(ap)
    return ap


def _rank(args, shape) -> dict:
    """One rank's build (and census) on the (D, S) mesh of this world."""
    from betacores_tpu_torch.parallel import (make_mesh, make_sharded_incremental_builder,
                                              shard_data)

    mesh = make_mesh(*shape)
    dev = mesh.device
    g = keyed(args, 0, device=dev)
    X, y, _ = gen_synthetic_logreg(g, args.n, d=D_FEAT, dtype=torch.float32)
    _, _, Z, _ = perturb_logreg(g, X, y, f_rate=0.1)
    del X, y
    cfg = IncrementalConfig(projection_dim=args.proj_dim,
                            n_subsample_select=args.n_subsample_select,
                            n_subsample_opt=args.n_subsample_opt,
                            opt_itrs=args.opt_itrs, i0=1.0, use_beta=True)
    model, sampler = logreg.bundle(), logreg_laplace_sampler()
    Zs, n_true = shard_data(Z, mesh)
    build = make_sharded_incremental_builder(Zs, n_true, model, sampler, cfg, mesh)
    st0 = init_state(M_BUF, D_FEAT, beta=BETA, dtype=torch.float32, device=dev)
    mesh.calls.clear()
    sync(dev)
    t0 = time.perf_counter()
    st = build.build(st0, args.itrs, build.generator_draws(seed_of(args, 2)))
    sync(dev)
    out = {"t_total": time.perf_counter() - t0, "m": int(st.m), "w": st.wts.cpu().numpy(),
           "idcs": st.idcs.cpu().numpy(), "calls": dict(mesh.calls), "route": build.route,
           "shape": dict(mesh.shape)}

    if args.census:
        n_data, n_samp = shape
        N_c = 16 * n_data + 3
        cfg_c = IncrementalConfig(
            projection_dim=n_samp * 4,
            n_subsample_select=None if args.n_subsample_select is None else 8 * n_data,
            n_subsample_opt=None if args.n_subsample_opt is None else 4 * n_data,
            opt_itrs=CENSUS_ITRS, i0=1.0, use_beta=True)
        Zcs, nc_true = shard_data(Z[:N_c], mesh)
        build_c = make_sharded_incremental_builder(Zcs, nc_true, model, sampler, cfg_c, mesh)
        draws = build_c.generator_draws(seed_of(args, 2))
        st_c = init_state(8, D_FEAT, beta=BETA, dtype=torch.float32, device=dev)
        mesh.calls.clear()
        st_c = build_c.select(st_c, draws, 0)
        sel = dict(mesh.calls)
        mesh.calls.clear()
        build_c.optimize(st_c, draws, 0)
        steps = collections.Counter(mesh.calls)
        if any(v % CENSUS_ITRS for v in steps.values()):
            raise AssertionError(f"census: {dict(steps)} over {CENSUS_ITRS} steps")
        out["census"] = (sel, {k: v // CENSUS_ITRS for k, v in steps.items()})
    return out


def main(argv=None):
    """Returns rank 0's record: ``m``, ``w``, ``idcs``, ``ok``, ``calls``
    (its collectives in the build), ``route``, ``t_total``, ``census``."""
    args = parser().parse_args(argv)
    if args.full_gradient:
        args.full_data = True
        args.n_subsample_opt = None
    if args.full_data:
        args.n_subsample_select = None
    shape = parse_mesh(args.mesh)
    from betacores_tpu_torch.parallel import run_world, world_backend

    n_ranks = shape[0] * shape[1]
    backend = world_backend(args.device, n_ranks)
    rec = run_world(_rank, n_ranks, backend, (args, shape))[0]
    N, w, m = args.n, rec["w"], rec["m"]
    idcs = rec["idcs"][:m]
    ok = bool(m > 0 and np.isfinite(w).all() and (w >= 0).all()
              and (idcs >= 0).all() and (idcs < N).all()
              and len(set(idcs.tolist())) == len(idcs))
    rec["ok"] = ok
    mode = ("full-gradient" if args.full_gradient
            else "full-select" if args.full_data else "headline")
    print(f"[{mode}] mesh={{'data': {shape[0]}, 'samp': {shape[1]}}} N={N} M={args.itrs} "
          f"S={args.proj_dim} opt_itrs={args.opt_itrs}: "
          f"selected m={m}, nnz(w)={(w > 0).sum()}, "
          f"sum(w)={w.sum():.1f} (N={N}), "
          f"wall={rec['t_total']:.1f}s ({backend}, {n_ranks} ranks, "
          f"{device_line(args.device)}), ok={ok}")
    if args.census:
        sel, step = rec["census"]
        want = CENSUS[mode]
        print(f"[{mode}] collective census (1 select + {CENSUS_ITRS} Adam steps, "
              f"torch.distributed calls of rank 0): select {sel}, per Adam step {step}; "
              f"the design's {want[0]}, {want[1]}: "
              f"{'equal' if (sel, step) == want else 'DIFFERENT'}")
    if not ok:
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
