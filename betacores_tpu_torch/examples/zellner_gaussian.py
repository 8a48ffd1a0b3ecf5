"""Synthetic contaminated-Gaussian coreset experiment, through the port
(counterpart of examples/zellner_gaussian.py).

N Gaussian points plus three outlier clusters; builds a {BCORES, BPSVI,
SVI, GIGAO, GIGAR, IHTO, IHTR, RAND, PRIOR} coreset for sizes m = 1..M and
scores each size by the closed-form reverse and forward KL against the
clean-data posterior.

Usage: python -m betacores_tpu_torch.examples.zellner_gaussian --alg BCORES --trial 1
"""

import argparse
import math
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch import snnls as snnls_mod
from betacores_tpu_torch.data import gen_synthetic_gaussian
from betacores_tpu_torch.evaluation import reverse_forward_kl
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed, sync
from betacores_tpu_torch.inference import gaussian_conjugate_sampler, prior_gaussian_sampler
from betacores_tpu_torch.models import gaussian as gmod

ALGS = ["BCORES", "BPSVI", "SVI", "GIGAO", "GIGAR", "IHTO", "IHTR", "RAND", "PRIOR"]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--M", type=int, default=200)
    ap.add_argument("--N", type=int, default=5000)
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--proj-dim", type=int, default=200)
    ap.add_argument("--opt-itrs", type=int, default=1000)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--i0", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--learn-beta", action="store_true",
                    help="jointly optimize beta by gradient")
    ap.add_argument("--pihat-noise", type=float, default=0.75)
    ap.add_argument("--select-beta", action="store_true",
                    help="BCORES only: pick beta by the trimmed held-out predictive "
                         "criterion over --beta-grid before the main trajectory")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2,
                    help="fraction of lowest held-out scores to drop")
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    kd = keyed(args, args.trial)
    X, Xc, Sig = gen_synthetic_gaussian(kd, N=args.N, d=args.d, dtype=torch.float32)
    d = args.d
    f32 = dict(dtype=torch.float32, device=dev)
    mu0, Sig0 = torch.zeros(d, **f32), torch.eye(d, **f32)
    Sig0inv = torch.eye(d, **f32)
    Sig_np = host(Sig).astype(np.float64)
    Siginv = torch.from_numpy(np.linalg.inv(Sig_np).astype(np.float32)).to(dev)
    logdetSig = float(np.linalg.slogdet(Sig_np)[1])

    model = gmod.bundle(Siginv, logdetSig)
    sampler_w = gaussian_conjugate_sampler(mu0, Sig0inv, Siginv)
    # the true posterior of the clean data
    post_full = gmod.weighted_post(mu0, Sig0inv, Siginv, X, torch.ones(X.shape[0], **f32))

    sched = lambda i: args.i0 / (1.0 + i)
    S = args.proj_dim
    prj_w = bc.BlackBoxProjector(sampler_w, S, model=model)
    prj_bw = bc.BetaBlackBoxProjector(sampler_w, S, model=model)

    # the mis-tuned projector of GIGAR
    kh = keyed(args, args.trial + 500_000)
    U = float(torch.rand((), generator=kh, device=dev))
    muhat = U * post_full.mu
    Sighat = U * post_full.cov + (1.0 - U) * Sig0
    muhat = muhat + args.pihat_noise * torch.linalg.norm(muhat) * torch.randn(
        d, generator=kh, **f32)
    Sighat = Sighat * torch.exp(-2 * args.pihat_noise * torch.abs(
        torch.randn((), generator=kh, **f32)))
    sampler_opt = prior_gaussian_sampler(post_full.mu, torch.linalg.cholesky(post_full.cov))
    sampler_real = prior_gaussian_sampler(muhat, torch.linalg.cholesky(Sighat))
    prj_opt = bc.BlackBoxProjector(sampler_opt, S, model=model)
    prj_real = bc.BlackBoxProjector(sampler_real, S, model=model)

    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, step_sched=sched,
                  seed=args.trial, max_size=args.M, device=dev)
    algs = {
        "BCORES": lambda: bc.BetaCoreset(Xc, prj_bw, beta=args.beta,
                                         learn_beta=args.learn_beta, **common),
        "SVI": lambda: bc.SparseVICoreset(Xc, prj_w, **common),
        "BPSVI": lambda: bc.BatchPSVICoreset(Xc, prj_w, opt_itrs=args.opt_itrs,
                                             n_subsample_opt=args.n_subsample_opt,
                                             step_sched=lambda m: sched,
                                             seed=args.trial, max_size=args.M, device=dev),
        "GIGAO": lambda: bc.HilbertCoreset(Xc, prj_opt, seed=args.trial, device=dev),
        "GIGAR": lambda: bc.HilbertCoreset(Xc, prj_real, seed=args.trial, device=dev),
        "IHTO": lambda: bc.HilbertCoreset(Xc, prj_opt, seed=args.trial,
                                          snnls=snnls_mod.AccIHT, device=dev),
        "IHTR": lambda: bc.HilbertCoreset(Xc, prj_real, seed=args.trial,
                                          snnls=snnls_mod.AccIHT, device=dev),
        "RAND": lambda: bc.UniformSamplingCoreset(Xc, seed=args.trial, device=dev),
        "PRIOR": lambda: None,
    }

    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu_torch.coresets.select_beta import driver_select_beta, padded_scorer

        # a fresh held-out contaminated draw of the same generator: the
        # trimmed criterion needs no clean/dirty labels
        _, Xho, _ = gen_synthetic_gaussian(keyed(args, args.trial + 777_000), N=2000, d=d,
                                           dtype=torch.float32)
        M_sel = args.select_M or args.M
        alg_sel = bc.BetaCoreset(Xc, prj_bw, beta=args.beta, **common)

        def _pred_ll(wm, pm):
            # held-out predictive: x ~ N(mu_w, Sig + Sig_w), per-point log pdf
            post = gmod.weighted_post(mu0, Sig0inv, Siginv, pm, wm)
            L = torch.linalg.cholesky(Sig + post.cov)
            r = torch.linalg.solve_triangular(L, (Xho - post.mu).T, upper=False)
            return (-0.5 * torch.sum(r * r, dim=0) - torch.log(torch.diagonal(L)).sum()
                    - 0.5 * d * math.log(2.0 * math.pi))

        score_fn = padded_scorer(args.M, d, _pred_ll, device=dev)
        grid = [float(b) for b in args.beta_grid.split(",")]
        best_beta, select_record, cache = driver_select_beta(
            alg_sel, grid, score_fn, args.select_trim, M_sel)
        # the closed-form rKL of each candidate build against the clean
        # posterior: the oracle answer (reporting only)
        grid_rkl = {}
        for b, (wb, pb) in cache.items():
            post_b = gmod.weighted_post(
                mu0, Sig0inv, Siginv,
                torch.from_numpy(np.atleast_2d(pb).astype(np.float32)).to(dev),
                torch.from_numpy(np.atleast_1d(wb).astype(np.float32)).to(dev))
            grid_rkl[b] = float(reverse_forward_kl(post_b, post_full)[0])
        print("select-beta grid (beta: trimmed-pll | oracle rKL):")
        for b, s in zip(grid, select_record["scores"]):
            mark = " <- selected" if b == best_beta else ""
            print(f"  {b:g}: {s:.4f} | {grid_rkl[b]:.4g}{mark}")
        rkl_argmin = min(grid, key=lambda b: grid_rkl[b])
        print(f"selected beta = {best_beta:g} (oracle rKL argmin = {rkl_argmin:g}) "
              f"[{select_record['select_time_s']:.1f}s for {len(grid)} builds]")
        args.beta = best_beta
        select_record.update({"rkl": grid_rkl, "rkl_argmin": rkl_argmin})

    sync(dev)
    t0 = time.perf_counter()
    w = [np.zeros(1)]
    p = [np.zeros((1, d))]
    betas = [args.beta]
    alg = algs[args.alg]()
    if args.alg == "PRIOR":
        for m in range(1, args.M + 1):
            w.append(np.zeros(1))
            p.append(np.zeros((1, d)))
    elif args.alg == "BPSVI":
        from betacores_tpu_torch.coresets import bpsvi_build_batch

        builder = alg._builder_for(args.M)
        wts_b, pts_b, _ = bpsvi_build_batch(builder, keyed(args, args.trial + 1000),
                                            list(range(1, args.M + 1)), args.M,
                                            torch.zeros(d, **f32))
        wts_b, pts_b = host(wts_b), host(pts_b)
        for m in range(1, args.M + 1):
            keep = wts_b[m - 1] > 0
            w.append(wts_b[m - 1][keep])
            p.append(pts_b[m - 1][keep])
    elif args.alg in ("GIGAO", "GIGAR", "IHTO", "IHTR"):
        # one device loop records the weights after every greedy iteration
        Wtr = host(alg.snnls.build_trace(args.M))
        data_np = host(alg.data)
        for m in range(1, args.M + 1):
            keep = Wtr[m - 1] > 0
            w.append(Wtr[m - 1][keep])
            p.append(data_np[alg._row_map[keep]])
        alg._sync_state()
    elif args.alg == "RAND":
        for wm, pm, im in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    else:
        for wm, pm, im, bm in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
            if args.alg == "BCORES":
                betas.append(bm)
    sync(dev)
    build_time = time.perf_counter() - t0

    # the KL of every coreset size, zero-weight padded to one shape
    cap = max(len(np.atleast_1d(wm)) for wm in w)
    Wpad = np.zeros((args.M + 1, cap), dtype=np.float32)
    Ppad = np.zeros((args.M + 1, cap, d), dtype=np.float32)
    for m in range(args.M + 1):
        wm, pm = np.atleast_1d(w[m]), np.atleast_2d(p[m])
        Wpad[m, : len(wm)] = wm
        Ppad[m, : len(wm)] = pm
    Wpad, Ppad = torch.from_numpy(Wpad).to(dev), torch.from_numpy(Ppad).to(dev)
    kls = [reverse_forward_kl(gmod.weighted_post(mu0, Sig0inv, Siginv, Ppad[m], Wpad[m]),
                              post_full) for m in range(args.M + 1)]
    rklw = host(torch.stack([k[0] for k in kls]))
    fklw = host(torch.stack([k[1] for k in kls]))

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"{args.alg}_{args.trial}"
    if args.alg == "BCORES":
        tag += f"_b{args.beta}" + ("_learned" if args.learn_beta else "") \
            + ("_selected" if args.select_beta else "")
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"alg": args.alg, "trial": args.trial, "w": w, "p": p,
                     "rklw": rklw, "fklw": fklw, "betas": betas,
                     "build_time_s": build_time, "select_beta": select_record,
                     "mup": host(post_full.mu), "Sigp": host(post_full.cov)}, fh)
    print(f"{args.alg} trial {args.trial}: build {build_time:.1f}s, "
          f"rKL[1]={rklw[1]:.3f} rKL[M]={rklw[args.M]:.3f} -> {out}")
    return out


if __name__ == "__main__":
    main()
