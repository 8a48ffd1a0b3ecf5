"""Bayesian-logistic-regression coreset experiment on UCI-scale data, through
the port (counterpart of examples/zellner_logreg.py).

Loads an npz dataset (or generates a synthetic one), whitens the
covariates, injects f_rate corruption, builds a {BCORES, SVI, BPSVI, RAND,
PRIOR} coreset up to size M with the Laplace sampler (BCORES and SVI refine
through the fused step, K1, on the card), then evaluates every
``--eval-every``-th size by HMC on the weighted posterior (NUTS when the
diagnostics fail) with the test accuracy and predictive log-likelihood.

Usage: python -m betacores_tpu_torch.examples.zellner_logreg --alg BCORES \\
          --dataset synth_lr --trial 1 --f-rate 0.1 [--device cpu]
"""

import argparse
import math
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
from betacores_tpu_torch.data.loaders import load_npz, reference_dataset_path, std_cov
from betacores_tpu_torch.evaluation import compute_accuracy, predictive_loglik
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed, sync
from betacores_tpu_torch.inference import HMCConfig, hmc, logreg_laplace_sampler
from betacores_tpu_torch.models import logreg

ALGS = ["BCORES", "SVI", "BPSVI", "RAND", "PRIOR"]


def load_dataset(args):
    """(X, Y, Z, Xt, Yt, Zt) on ``args.device``: the npz dataset whitened,
    or the synthetic fallback (a dataset the repo lacks is never fetched)."""
    path = reference_dataset_path(args.dataset)
    if path is not None:
        X, Y, Xt, Yt = load_npz(path)
        X, Y, Z, mean_, cov_ = std_cov(X, Y)
        Xt, Yt, Zt, _, _ = std_cov(Xt, Yt, mean_, cov_)
        return tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(args.device)
                     for a in (X, Y, Z, Xt, Yt, Zt))
    gen = keyed(args, args.trial + 7)
    X, Y, Z = gen_synthetic_logreg(gen, args.synth_N, d=args.synth_d)
    Xt, Yt, Zt = gen_synthetic_logreg(gen, max(2000, args.synth_N // 6), d=args.synth_d)
    return X, Y, Z, Xt, Yt, Zt


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--dataset", default="synth_lr")
    ap.add_argument("--synth-N", type=int, default=12000,
                    help="rows for the synthetic generator (used when "
                         "--dataset resolves to no npz)")
    ap.add_argument("--synth-d", type=int, default=10,
                    help="feature dim for the synthetic generator")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--graddiag", action="store_true")
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--structured", action="store_true",
                    help="structured boundary attack instead of unstructured noise+flips")
    ap.add_argument("--M", type=int, default=100)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=500)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--refit-every", type=int, default=1,
                    help="lagged Laplace refits in the Adam loop (1 = refit every step)")
    ap.add_argument("--dedup-select", action="store_true",
                    help="mask already-selected indices out of the candidate argmax")
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--select-beta", action="store_true",
                    help="BCORES only: pick beta by the trimmed held-out predictive "
                         "criterion over --beta-grid before the main trajectory")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2,
                    help="fraction of lowest held-out scores to drop")
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--eval-every", type=int, default=10,
                    help="evaluate accuracy/pll every k-th coreset size")
    ap.add_argument("--mcmc-samples", type=int, default=1000)
    ap.add_argument("--mcmc-warmup", type=int, default=1000)
    ap.add_argument("--mcmc-chains", type=int, default=2,
                    help="HMC chains per evaluated size (>= 2: split-R-hat/ESS checks)")
    ap.add_argument("--eval-sampler", choices=["hmc", "nuts"], default="hmc",
                    help="evaluation sampler: multinomial HMC or NUTS")
    ap.add_argument("--eval-full-data", action="store_true",
                    help="also evaluate a full-data posterior baseline, subsampled to "
                         "--full-data-cap rows")
    ap.add_argument("--full-data-cap", type=int, default=5000)
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    X, Y, Z, Xt, Yt, Zt = load_dataset(args)
    X, Y, Z, out_idx = perturb_logreg(keyed(args, args.trial), X, Y, f_rate=args.f_rate,
                                      structured=args.structured)
    D = X.shape[1]
    print(f"dataset {args.dataset}: N={X.shape[0]} d={D}, corrupted {len(out_idx)}")

    model = logreg.bundle()
    sampler_w = logreg_laplace_sampler(diag=args.graddiag)
    sched = lambda i: args.i0 / (1.0 + i)
    S = args.proj_dim
    prj_w = bc.BlackBoxProjector(sampler_w, S, model=model)
    prj_bw = bc.BetaBlackBoxProjector(sampler_w, S, model=model)

    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, step_sched=sched,
                  seed=args.trial, max_size=args.M, refit_every=args.refit_every,
                  dedup_select=args.dedup_select, device=dev)
    algs = {
        "BCORES": lambda: bc.BetaCoreset(Z, prj_bw, beta=args.beta, learn_beta=False, **common),
        "SVI": lambda: bc.SparseVICoreset(Z, prj_w, **common),
        "BPSVI": lambda: bc.BatchPSVICoreset(Z, prj_w, opt_itrs=args.opt_itrs,
                                             n_subsample_opt=args.n_subsample_opt,
                                             step_sched=lambda m: sched,
                                             seed=args.trial, max_size=args.M, device=dev),
        "RAND": lambda: bc.UniformSamplingCoreset(Z, seed=args.trial, device=dev),
        "PRIOR": lambda: None,
    }
    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu_torch.coresets.select_beta import driver_select_beta, padded_scorer

        # hold out a slice of the corrupted training rows; builds use the rest
        n_ho = min(2000, max(1, Z.shape[0] // 6))
        Zho, Zbuild = Z[-n_ho:], Z[: Z.shape[0] - n_ho]
        M_sel = args.select_M or args.M
        alg_sel = bc.BetaCoreset(Zbuild, prj_bw, beta=args.beta, learn_beta=False, **common)
        S_score = 256

        def _pred_ll(wm, pm):
            # per-point held-out predictive log-lik under the coreset's Laplace
            # posterior, log mean_s p(z | th_s), under one fixed draw
            samples, _ = sampler_w(keyed(args, args.trial * 31 + 5), S_score, wm, pm,
                                   torch.zeros(D, device=dev))
            ll = logreg.log_likelihood(Zho, samples)
            return torch.logsumexp(ll, dim=1) - math.log(S_score)

        score_fn = padded_scorer(args.M, D, _pred_ll, device=dev)
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
    p = [np.zeros((1, D), dtype=np.float32)]
    if args.alg == "PRIOR":
        for m in range(1, args.M + 1):
            w.append(np.zeros(1))
            p.append(np.zeros((1, D), dtype=np.float32))
    elif args.alg == "BPSVI":
        from betacores_tpu_torch.coresets import bpsvi_build_batch

        builder = alg._builder_for(args.M)
        wts_b, pts_b, _ = bpsvi_build_batch(builder, keyed(args, args.trial + 1000),
                                            list(range(1, args.M + 1)), args.M,
                                            torch.zeros(D, device=dev))
        wts_b, pts_b = host(wts_b), host(pts_b)
        for m in range(1, args.M + 1):
            keep = wts_b[m - 1] > 0
            w.append(wts_b[m - 1][keep])
            p.append(pts_b[m - 1][keep])
    elif args.alg == "RAND":
        for wm, pm, im in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    else:
        for wm, pm, im, bm in alg.build_trace(args.M):
            w.append(wm)
            p.append(pm)
    sync(dev)
    build_time = time.perf_counter() - t0
    print(f"build: {build_time:.1f}s")

    # evaluation: HMC on the weighted coreset posterior per size, NUTS when
    # the split-R-hat/ESS/divergence diagnostics fail
    from betacores_tpu_torch.inference import (default_nuts_config, run_with_escalation,
                                               summarize_chains)
    from betacores_tpu_torch.inference.nuts import run_chains_weighted_logreg_nuts

    eval_ms = sorted(set(range(0, args.M + 1, args.eval_every)) | {args.M})
    accs, plls, mcmc_times, diags = {}, {}, {}, {}
    nuts_cfg = default_nuts_config(args.mcmc_samples, args.mcmc_warmup)
    if args.eval_sampler == "nuts":
        cfg = nuts_cfg
        run_eval_chains = run_chains_weighted_logreg_nuts
    else:
        cfg = HMCConfig(n_samples=args.mcmc_samples, n_warmup=args.mcmc_warmup, L_max=32)
        run_eval_chains = hmc.run_chains_weighted_logreg
    # zero-weight pad every coreset to one static shape (zero-weight rows
    # are inert), so every evaluated size reuses one sampler's graphs
    eval_cap = max(len(np.atleast_1d(w[m])) for m in eval_ms)
    theta0 = torch.zeros(D, device=dev)
    for m in eval_ms:
        wm_c = np.atleast_1d(w[m]).astype(np.float32)
        pm_c = np.atleast_2d(p[m]).astype(np.float32)
        wm = torch.from_numpy(np.pad(wm_c, (0, eval_cap - len(wm_c)))).to(dev)
        pm = torch.from_numpy(np.pad(pm_c, ((0, eval_cap - len(wm_c)), (0, 0)))).to(dev)
        t1 = time.perf_counter()
        run = run_with_escalation(keyed(args, args.trial * 100 + m), run_eval_chains, cfg,
                                  run_chains_weighted_logreg_nuts, nuts_cfg, pm, wm, theta0,
                                  args.mcmc_chains, primary_name=args.eval_sampler)
        sync(dev)
        mcmc_times[m] = time.perf_counter() - t1
        diags[m] = {k: host(v) for k, v in run.summary.items()}
        diags[m]["sampler_used"] = run.sampler_used
        diags[m]["escalated"] = run.escalated
        samples = run.chains.reshape(-1, D)
        accs[m] = float(compute_accuracy(Xt, Yt, samples))
        plls[m] = float(predictive_loglik(Zt, samples))
        rhat, ess = float(diags[m]["rhat"].max()), float(diags[m]["ess"].min())
        flag = ("" if not run.escalated else
                f"  ** {args.eval_sampler} failed ({run.failure_reason}); "
                "recorded NUTS re-run")
        print(f"m={m:4d} acc={accs[m]:.4f} pll={plls[m]:.4f} "
              f"accept={float(np.mean(host(run.stats['accept_stat']))):.2f} "
              f"rhat={rhat:.3f} ess={ess:.0f} [{run.sampler_used}] "
              f"({mcmc_times[m]:.1f}s){flag}")

    full = None
    if args.eval_full_data:
        # the full-data MCMC baseline on a <= full_data_cap uniform subsample
        # with weights N/n
        N = Z.shape[0]
        n_fd = min(args.full_data_cap, N)
        sub = (np.random.default_rng(args.trial).choice(N, n_fd, replace=False)
               if n_fd < N else np.arange(N))
        w_fd = torch.full((n_fd,), N / n_fd, dtype=torch.float32, device=dev)
        t1 = time.perf_counter()
        fd_cfg = (cfg if isinstance(cfg, HMCConfig) else
                  HMCConfig(n_samples=args.mcmc_samples, n_warmup=args.mcmc_warmup, L_max=32))
        chains, stats = hmc.run_chains_weighted_logreg(
            keyed(args, args.trial * 100 + 999), Z[torch.from_numpy(sub).to(dev)], w_fd,
            theta0, args.mcmc_chains, fd_cfg)
        sync(dev)
        t_fd = time.perf_counter() - t1
        samples = chains.reshape(-1, D)
        full = {"n_subsample": int(n_fd),
                "acc": float(compute_accuracy(Xt, Yt, samples)),
                "pll": float(predictive_loglik(Zt, samples)),
                "mcmc_time_s": t_fd,
                "diag": {k: host(v) for k, v in summarize_chains(chains).items()}}
        print(f"full-data baseline (n={n_fd}): acc={full['acc']:.4f} "
              f"pll={full['pll']:.4f} ({t_fd:.1f}s)")

    os.makedirs(args.results_dir, exist_ok=True)
    # config-encoding filename: every swept hyperparameter is in it
    tag = f"{args.dataset}_{args.alg}_{args.trial}_{args.f_rate}_b{args.beta}_i{args.i0}"
    if args.dedup_select:
        tag += "_dedup"
    if args.graddiag:
        tag += "_gd"
    if args.select_beta:
        tag += "_selected"
    if args.structured:
        tag += "_struct"
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "w": w, "p": p, "accs": accs, "plls": plls,
                     "build_time_s": build_time, "mcmc_times": mcmc_times,
                     "mcmc_diagnostics": diags, "full_data": full,
                     "select_beta": select_record}, fh)
    print(f"saved -> {out}")
    return out


if __name__ == "__main__":
    main()
