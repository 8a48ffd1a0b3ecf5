"""Robust summarization with unknown covariance (Normal-Inverse-Wishart),
through the port (counterpart of examples/mvn_unknown_cov.py).

Contaminated multivariate data where both the mean and the covariance are
inferred, summarized by a {BCORES, SVI, RAND, PRIOR} coreset under the
exact conjugate NIW posterior (the builders' per-step-draw route). Reported
per evaluated size: the posterior-mean error against the clean-data
posterior, the inferred covariance scale tr(E[Sigma]), the NIW KL and the
Student-t test log-likelihood.

Usage: python -m betacores_tpu_torch.examples.mvn_unknown_cov --alg BCORES --f-rate 0.1
"""

import argparse
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.examples._common import add_port_flags, sync
from betacores_tpu_torch.models import mvn

ALGS = ["BCORES", "SVI", "RAND", "PRIOR"]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--N", type=int, default=3000)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--outlier-shift", type=float, default=10.0)
    ap.add_argument("--M", type=int, default=30)
    ap.add_argument("--proj-dim", type=int, default=64)
    ap.add_argument("--opt-itrs", type=int, default=150)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=500)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--select-beta", action="store_true",
                    help="pick beta by the trimmed held-out predictive criterion over "
                         "--beta-grid, scored by the closed-form NIW Student-t "
                         "predictive log-pdf (BCORES only)")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2)
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    f32 = dict(dtype=torch.float32, device=dev)
    # the data from the host generators of the JAX driver (its data does not
    # depend on a key): the same rows in both implementations
    rng = np.random.default_rng(args.trial)
    d = args.d
    A = rng.normal(size=(d, d)) * 0.3
    Sig_true = A @ A.T + np.eye(d)
    X = rng.multivariate_normal(np.ones(d) * 2.0, Sig_true, args.N)
    rng_test = np.random.default_rng(10_000 + args.trial)
    Xtest = torch.tensor(rng_test.multivariate_normal(np.ones(d) * 2.0, Sig_true, 500), **f32)
    n_out = int(args.f_rate * args.N)
    Xout = rng.normal(size=(n_out, d)) * 0.5 + args.outlier_shift
    Xc = torch.tensor(np.vstack([X, Xout]), **f32)
    print(f"N={args.N} d={d} outliers={n_out} shift={args.outlier_shift}")

    mu0, kappa0 = torch.zeros(d, **f32), 1.0
    Psi0, nu0 = torch.eye(d, **f32) * 2.0, d + 4.0
    model = mvn.bundle(d)
    sampler = mvn.mvn_niw_sampler(mu0, kappa0, Psi0, nu0)
    sched = lambda i: args.i0 / (1.0 + i)
    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, step_sched=sched,
                  seed=args.trial, max_size=args.M, device=dev)
    td = d + d * d
    prj_b = bc.BetaBlackBoxProjector(sampler, args.proj_dim, theta_dim=td, model=model)
    prj = bc.BlackBoxProjector(sampler, args.proj_dim, theta_dim=td, model=model)
    algs = {
        "BCORES": lambda: bc.BetaCoreset(Xc, prj_b, beta=args.beta, **common),
        "SVI": lambda: bc.SparseVICoreset(Xc, prj, **common),
        "RAND": lambda: bc.UniformSamplingCoreset(Xc, seed=args.trial, device=dev),
        "PRIOR": lambda: None,
    }

    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu_torch.coresets.select_beta import driver_select_beta, padded_scorer

        # hold out a slice of the corrupted rows; builds use the rest
        n_ho = min(2000, max(1, Xc.shape[0] // 6))
        Xho, Xbuild = Xc[-n_ho:], Xc[: Xc.shape[0] - n_ho]
        M_sel = args.select_M or args.M
        alg_sel = bc.BetaCoreset(Xbuild, prj_b, beta=args.beta, **common)

        def _pred_ll(wm, pm):
            # the closed-form per-point Student-t predictive of the coreset's
            # NIW posterior
            return mvn.predictive_logpdf(Xho, mvn.weighted_post(mu0, kappa0, Psi0, nu0,
                                                                pm, wm))

        score_fn = padded_scorer(args.M, d, _pred_ll, device=dev)
        grid = [float(b) for b in args.beta_grid.split(",")]
        best_beta, select_record, _ = driver_select_beta(alg_sel, grid, score_fn,
                                                         args.select_trim, M_sel)
        print("select-beta grid: " + "  ".join(
            f"{b:g}:{s:.4f}" for b, s in zip(grid, select_record["scores"])))
        print(f"selected beta = {best_beta:g} "
              f"[{select_record['select_time_s']:.1f}s for {len(grid)} builds]")
        args.beta = best_beta

    alg = algs[args.alg]()

    sync(dev)
    t0 = time.perf_counter()
    w = [np.zeros(1)]
    p = [np.zeros((1, d), dtype=np.float32)]
    if args.alg == "PRIOR":
        for m in range(1, args.M + 1):
            w.append(np.zeros(1))
            p.append(np.zeros((1, d), dtype=np.float32))
    elif args.alg == "RAND":
        for wm, pm, im in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    else:
        for got in alg.build_trace(args.M):
            w.append(got[0])
            p.append(got[1])
    sync(dev)
    build_time = time.perf_counter() - t0
    print(f"build: {build_time:.1f}s")

    post_clean = mvn.weighted_post(mu0, kappa0, Psi0, nu0, torch.tensor(X, **f32),
                                   torch.ones(args.N, **f32))
    mu_err, sig_tr, rkl, pll = {}, {}, {}, {}
    for m in sorted(set(range(0, args.M + 1, args.eval_every)) | {args.M}):
        wm = torch.tensor(np.atleast_1d(w[m]).astype(np.float32), device=dev)
        pm = torch.tensor(np.atleast_2d(p[m]).astype(np.float32), device=dev)
        post = mvn.weighted_post(mu0, kappa0, Psi0, nu0, pm, wm)
        mu_err[m] = float(torch.linalg.norm(post.mu - post_clean.mu))
        sig_tr[m] = float(torch.trace(post.Psi) / (post.nu - d - 1))
        rkl[m] = float(mvn.niw_kl(post, post_clean))
        pll[m] = float(torch.mean(mvn.predictive_logpdf(Xtest, post)))
        print(f"m={m:3d} |mu - mu_clean|={mu_err[m]:.4f} "
              f"tr(E[Sigma])={sig_tr[m]:.2f} rKL={rkl[m]:.4g} pll={pll[m]:.4f}")

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"mvn_{args.alg}_{args.trial}_{args.f_rate}_b{args.beta}"
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "w": w, "p": p, "mu_err": mu_err,
                     "sig_tr": sig_tr, "rkl": rkl, "pll": pll,
                     "build_time_s": build_time, "select_beta": select_record}, fh)
    print(f"saved -> {out}")
    return out


if __name__ == "__main__":
    main()
