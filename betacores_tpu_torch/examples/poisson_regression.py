"""Poisson-regression coreset experiment on count data, through the port
(counterpart of examples/poisson_regression.py).

Loads a count dataset (or generates a synthetic one), injects gross count
corruption at rate ``--f-rate``, builds a {BCORES, SVI, RAND, PRIOR}
coreset with the Fisher-scoring Laplace sampler, and evaluates each size's
weighted posterior by the test-set predictive log-likelihood (Laplace, or
HMC / NUTS).

Usage: python -m betacores_tpu_torch.examples.poisson_regression --alg BCORES --dataset biketrips
"""

import argparse
import math
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.data import gen_synthetic_poisson
from betacores_tpu_torch.data.loaders import reference_dataset_path
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed, sync
from betacores_tpu_torch.inference import poisson_laplace_sampler
from betacores_tpu_torch.models import poisson

ALGS = ["BCORES", "SVI", "RAND", "PRIOR"]


def load_dataset(args):
    """(X, y, Xt, yt) as numpy arrays: the npz standardized with an
    intercept column, or the synthetic fallback (a dataset the repo lacks is
    never fetched)."""
    path = reference_dataset_path(args.dataset)
    if path is not None:
        data = np.load(path, allow_pickle=True)
        X, y = np.asarray(data["X"], float), np.asarray(data["y"], float).reshape(-1)
        Xt, yt = np.asarray(data["Xt"], float), np.asarray(data["yt"], float).reshape(-1)
        mu, sd = X.mean(0), X.std(0) + 1e-8
        X, Xt = (X - mu) / sd, (Xt - mu) / sd
        X = np.c_[X, np.ones(len(X))]
        Xt = np.c_[Xt, np.ones(len(Xt))]
        return tuple(a.astype(np.float32) for a in (X, y, Xt, yt))
    gen = keyed(args, args.trial + 3)
    X, y, _, _ = gen_synthetic_poisson(gen, N=2000, d=6)
    Xt, yt, _, _ = gen_synthetic_poisson(gen, N=400, d=6)
    return host(X), host(y), host(Xt), host(yt)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--dataset", default="biketrips")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--corrupt-shift", type=float, default=50.0)
    ap.add_argument("--M", type=int, default=50)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=300)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=500)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--select-beta", action="store_true",
                    help="pick beta by the trimmed held-out predictive criterion over "
                         "--beta-grid before the reported build (BCORES only)")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2,
                    help="fraction of lowest held-out scores to drop")
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--refit-every", type=int, default=1,
                    help="lagged Fisher-scoring refits in the Adam loop")
    ap.add_argument("--dedup-select", action="store_true",
                    help="mask already-selected indices out of the candidate argmax")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--eval", choices=["laplace", "hmc", "nuts"], default="laplace",
                    help="posterior for the predictive eval: the Laplace fit or "
                         "multi-chain HMC / NUTS on the weighted Poisson posterior")
    ap.add_argument("--mcmc-samples", type=int, default=1000)
    ap.add_argument("--mcmc-warmup", type=int, default=1000)
    ap.add_argument("--mcmc-chains", type=int, default=2)
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    X, y, Xt, yt = load_dataset(args)
    rng = np.random.default_rng(args.trial)
    n_bad = int(args.f_rate * len(y))
    bad = rng.choice(len(y), size=n_bad, replace=False)
    y = np.asarray(y, dtype=np.float32).copy()
    y[bad] += args.corrupt_shift  # gross count corruption
    Z = torch.from_numpy(np.c_[X, y].astype(np.float32)).to(dev)
    Zt = torch.from_numpy(np.c_[Xt, yt].astype(np.float32)).to(dev)
    d = X.shape[1]
    print(f"dataset {args.dataset}: N={len(y)} d={d}, corrupted {n_bad}")

    # the Gaussian approximation of the mass term where the counts run high
    model = poisson.bundle(gaussian_mass=float(np.max(y)) > 30.0,
                           k_max=int(min(np.max(y) * 2 + 20, 128)))
    sampler = poisson_laplace_sampler()
    sched = lambda i: args.i0 / (1.0 + i)
    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, step_sched=sched,
                  seed=args.trial, max_size=args.M, refit_every=args.refit_every,
                  dedup_select=args.dedup_select, device=dev)
    prj_b = bc.BetaBlackBoxProjector(sampler, args.proj_dim, theta_dim=d, model=model)
    prj = bc.BlackBoxProjector(sampler, args.proj_dim, theta_dim=d, model=model)
    algs = {
        "BCORES": lambda: bc.BetaCoreset(Z, prj_b, beta=args.beta, learn_beta=False, **common),
        "SVI": lambda: bc.SparseVICoreset(Z, prj, **common),
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
        alg_sel = bc.BetaCoreset(Zbuild, prj_b, beta=args.beta, learn_beta=False, **common)
        S_score = 256

        def _pred_ll(wm, pm):
            samples, _ = sampler(keyed(args, args.trial * 31 + 5), S_score, wm, pm,
                                 torch.zeros(d, device=dev))
            ll = model.log_likelihood(Zho, samples)
            return torch.logsumexp(ll, dim=1) - math.log(S_score)

        score_fn = padded_scorer(args.M, d + 1, _pred_ll, device=dev)
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
    p = [np.zeros((1, d + 1), dtype=np.float32)]
    if args.alg == "PRIOR":
        for m in range(1, args.M + 1):
            w.append(np.zeros(1))
            p.append(np.zeros((1, d + 1), dtype=np.float32))
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

    # each evaluated size's posterior (zero-weight padded to one shape),
    # scored by the test predictive log-likelihood; the final size always
    eval_ms = sorted(set(range(0, args.M + 1, args.eval_every)) | {args.M})
    cap = max(len(np.atleast_1d(w[m])) for m in eval_ms)
    theta0 = torch.zeros(d, device=dev)

    def eval_fn(gen, wm, pm):
        samples, _ = sampler(gen, 256, wm, pm, theta0)
        return poisson.predictive_loglik(Zt, samples)

    use_mcmc = args.eval in ("hmc", "nuts")
    if use_mcmc:
        from betacores_tpu_torch.inference import (HMCConfig, default_nuts_config,
                                                   run_chains_weighted_poisson,
                                                   run_with_escalation)
        from betacores_tpu_torch.inference.nuts import make_weighted_nuts

        # NUTS over the same weighted target: the primary with --eval nuts,
        # the escalation target when HMC fails its diagnostics
        nuts_cfg = default_nuts_config(args.mcmc_samples, args.mcmc_warmup)
        run_poisson_nuts = make_weighted_nuts(poisson.log_joint)
        if args.eval == "nuts":
            mcmc_cfg, run_eval_chains = nuts_cfg, run_poisson_nuts
        else:
            mcmc_cfg = HMCConfig(n_samples=args.mcmc_samples, n_warmup=args.mcmc_warmup,
                                 L_max=32)
            run_eval_chains = run_chains_weighted_poisson

    plls, diags, mcmc_times = {}, {}, {}
    for m in eval_ms:
        wm_c = np.atleast_1d(w[m]).astype(np.float32)
        pm_c = np.atleast_2d(p[m]).astype(np.float32)
        wm = torch.from_numpy(np.pad(wm_c, (0, cap - len(wm_c)))).to(dev)
        pm = torch.from_numpy(np.pad(pm_c, ((0, cap - len(wm_c)), (0, 0)))).to(dev)
        key_m = keyed(args, args.trial * 100 + m)
        if use_mcmc:
            t1 = time.perf_counter()
            run = run_with_escalation(key_m, run_eval_chains, mcmc_cfg, run_poisson_nuts,
                                      nuts_cfg, pm, wm, theta0, args.mcmc_chains,
                                      primary_name=args.eval)
            sync(dev)
            mcmc_times[m] = time.perf_counter() - t1
            diags[m] = {k: host(v) for k, v in run.summary.items()}
            diags[m]["sampler_used"] = run.sampler_used
            diags[m]["escalated"] = run.escalated
            if "n_divergent" in run.stats:
                diags[m]["n_divergent"] = host(run.stats["n_divergent"])
            plls[m] = float(poisson.predictive_loglik(Zt, run.chains.reshape(-1, d)))
            flag = ("" if not run.escalated else
                    f"  ** {args.eval} failed ({run.failure_reason}); recorded NUTS re-run")
            print(f"m={m:4d} pll={plls[m]:.4f} "
                  f"rhat={float(diags[m]['rhat'].max()):.3f} "
                  f"ess={float(diags[m]['ess'].min()):.0f} "
                  f"[{run.sampler_used}] ({mcmc_times[m]:.2f}s){flag}")
        else:
            plls[m] = float(eval_fn(key_m, wm, pm))
            print(f"m={m:4d} pll={plls[m]:.4f}")

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"{args.dataset}_{args.alg}_{args.trial}_{args.f_rate}_b{args.beta}"
    if args.dedup_select:
        tag += "_dedup"
    if args.eval != "laplace":
        tag += f"_{args.eval}"
    out = os.path.join(args.results_dir, f"results_poiss_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "w": w, "p": p, "plls": plls,
                     "build_time_s": build_time, "mcmc_times": mcmc_times,
                     "mcmc_diagnostics": diags, "select_beta": select_record}, fh)
    print(f"saved -> {out}")
    return out


if __name__ == "__main__":
    main()
