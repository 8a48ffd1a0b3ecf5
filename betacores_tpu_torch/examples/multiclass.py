"""Multiclass (softmax) robust summarization, through the port (counterpart
of examples/multiclass.py).

Synthetic K-class data (or an npz with integer classes) with label-flip
contamination, a BCORES/SVI/RAND build (select's projections over a block
of at least 8192 rows through the multiclass kernel, K2, on the card), and
the test accuracy of the coreset's Laplace posterior (or of weighted HMC /
NUTS) per coreset size.

Usage: python -m betacores_tpu_torch.examples.multiclass --alg BCORES --K 5 --f-rate 0.2
"""

import argparse
import math
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.data import gen_synthetic_multiclass
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed, sync
from betacores_tpu_torch.inference import (multiclass_laplace_sampler, newton_laplace,
                                           sample_laplace_from_noise)
from betacores_tpu_torch.models import multiclass as mc

ALGS = ["BCORES", "SVI", "RAND"]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--dataset", default="synthetic",
                    help="'synthetic' or an npz name with integer-class y "
                         "(e.g. movielens5 from preprocess.py movielens)")
    ap.add_argument("--K", type=int, default=5)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--N", type=int, default=50_000)
    ap.add_argument("--N-test", type=int, default=10_000)
    ap.add_argument("--f-rate", type=float, default=0.2)
    ap.add_argument("--M", type=int, default=60)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=200)
    ap.add_argument("--n-subsample-opt", type=int, default=200)
    ap.add_argument("--n-subsample-select", type=int, default=1000)
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--select-beta", action="store_true",
                    help="pick beta by the trimmed held-out predictive criterion over "
                         "--beta-grid before the reported build (BCORES only)")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.3,
                    help="fraction of lowest held-out scores to drop")
    ap.add_argument("--select-M", type=int, default=0,
                    help="coreset size for the selection builds (0 = --M)")
    ap.add_argument("--refit-every", type=int, default=1)
    ap.add_argument("--dedup-select", action="store_true",
                    help="mask already-selected indices out of the candidate argmax")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--eval", choices=["laplace", "hmc", "nuts"], default="laplace",
                    help="posterior for the accuracy metric: Laplace or weighted "
                         "K-class MCMC (HMC or NUTS, 2 chains with split-R-hat checks)")
    ap.add_argument("--mcmc-samples", type=int, default=500)
    ap.add_argument("--mcmc-warmup", type=int, default=500)
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    if args.dataset == "synthetic":
        K, d = args.K, args.d
        Xall, yall, Zall = gen_synthetic_multiclass(
            keyed(args, args.trial), args.N + args.N_test, d=d, n_classes=K,
            dtype=torch.float32)
        Z, Xt, yt = Zall[: args.N], Xall[args.N:], yall[args.N:]
        N = args.N
    else:
        from betacores_tpu_torch.data.loaders import load_npz, reference_dataset_path

        path = reference_dataset_path(args.dataset)
        if path is None:
            raise SystemExit(f"dataset npz not found: {args.dataset} "
                             f"(run examples/preprocess.py movielens)")
        X, y, Xt_np, yt_np = load_npz(path)
        if y.min() < 0 or yt_np.min() < 0:
            raise SystemExit(
                f"dataset {args.dataset} has labels in [{y.min()}, {y.max()}]: this "
                f"driver needs integer classes 0..K-1 (use movielens5, or the binary "
                f"drivers for {args.dataset})")
        K = int(max(y.max(), yt_np.max())) + 1
        d = X.shape[1]
        Z = torch.from_numpy(np.c_[X, y].astype(np.float32)).to(dev)
        Xt = torch.from_numpy(Xt_np.astype(np.float32)).to(dev)
        yt = torch.from_numpy(yt_np.astype(np.float32)).to(dev)
        N = Z.shape[0]
    # label-flip contamination: f_rate of rows get a wrong class
    rng = np.random.default_rng(args.trial)
    Zc = host(Z).copy()
    bad = rng.choice(N, int(N * args.f_rate), replace=False)
    Zc[bad, -1] = (Zc[bad, -1] + rng.integers(1, K, size=len(bad))) % K
    Zc = torch.from_numpy(Zc).to(dev)
    counts = torch.bincount(yt.to(torch.int64), minlength=K)
    base = float(torch.mean((yt == torch.argmax(counts)).to(torch.float32)))
    print(f"dataset={args.dataset} K={K} d={d} N={N} test={len(yt)} "
          f"f_rate={args.f_rate} base_rate={base:.4f}")

    model = mc.bundle(K)
    smp = multiclass_laplace_sampler(K)
    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  n_subsample_select=args.n_subsample_select, seed=args.trial,
                  max_size=args.M, refit_every=args.refit_every,
                  dedup_select=args.dedup_select, device=dev)
    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu_torch.coresets.select_beta import driver_select_beta, padded_scorer

        # hold out a slice of the corrupted training rows; builds on the rest
        n_ho = min(2000, max(1, Zc.shape[0] // 6))
        Zho, Zbuild = Zc[-n_ho:], Zc[: Zc.shape[0] - n_ho]
        M_sel = args.select_M or args.M
        prj_sel = bc.BetaBlackBoxProjector(smp, args.proj_dim, theta_dim=K * d, model=model)
        alg_sel = bc.BetaCoreset(Zbuild, prj_sel, beta=args.beta, learn_beta=False, **common)
        S_score = 256

        def _pred_ll(wm, pm):
            samples, _ = smp(keyed(args, args.trial * 31 + 5), S_score, wm, pm,
                             torch.zeros(K * d, device=dev))
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

    sync(dev)
    t0 = time.perf_counter()
    if args.alg == "BCORES":
        prj = bc.BetaBlackBoxProjector(smp, args.proj_dim, theta_dim=K * d, model=model)
        alg = bc.BetaCoreset(Zc, prj, beta=args.beta, learn_beta=False, **common)
        snaps = [(w, p) for (w, p, i, b) in alg.build_trace(args.M)]
    elif args.alg == "SVI":
        prj = bc.BlackBoxProjector(smp, args.proj_dim, theta_dim=K * d, model=model)
        alg = bc.SparseVICoreset(Zc, prj, **common)
        snaps = [(w, p) for (w, p, i, b) in alg.build_trace(args.M)]
    else:
        alg = bc.UniformSamplingCoreset(Zc, seed=args.trial, device=dev)
        snaps = [(w, p) for (w, p, i) in alg.build_trace(args.M)]
    sync(dev)
    t_build = time.perf_counter() - t0

    lj = mc.make_log_joint(K)
    g_of = mc.make_grad_th_log_joint(K)
    h_of = mc.make_hess_th_log_joint(K)

    mcmc_chains = None
    if args.eval in ("hmc", "nuts"):
        # weighted K-class posterior MCMC; failed diagnostics escalate HMC
        # to NUTS
        from betacores_tpu_torch.inference import default_nuts_config
        from betacores_tpu_torch.inference.nuts import make_weighted_nuts

        nuts_cfg = default_nuts_config(args.mcmc_samples, args.mcmc_warmup)
        nuts_chains = make_weighted_nuts(lj)
        if args.eval == "nuts":
            mcmc_cfg, mcmc_chains = nuts_cfg, nuts_chains
        else:
            from betacores_tpu_torch.inference.hmc import HMCConfig, make_weighted_hmc

            mcmc_cfg = HMCConfig(n_samples=args.mcmc_samples, n_warmup=args.mcmc_warmup,
                                 L_max=32)
            _, mcmc_chains = make_weighted_hmc(lj)

    cap = max((len(np.atleast_1d(w)) for w, _ in snaps), default=1)
    escalations = {}

    def acc_of(wts, pts, m=None):
        if len(wts) == 0:
            return base
        if mcmc_chains is not None:
            from betacores_tpu_torch.inference import run_with_escalation

            wp = np.zeros(cap, np.float32)
            wp[:len(wts)] = np.asarray(wts, np.float32)
            pp = np.zeros((cap, Zc.shape[1]), np.float32)
            pp[:len(wts)] = np.atleast_2d(np.asarray(pts, np.float32))
            run = run_with_escalation(
                keyed(args, 99), mcmc_chains, mcmc_cfg, nuts_chains, nuts_cfg,
                torch.from_numpy(pp).to(dev), torch.from_numpy(wp).to(dev),
                torch.zeros(K * d, device=dev), 2, primary_name=args.eval)
            if run.escalated:
                print(f"  ** {args.eval} failed ({run.failure_reason}); "
                      "recorded NUTS re-run")
            if m is not None:
                escalations[m] = {"sampler_used": run.sampler_used,
                                  "escalated": run.escalated,
                                  "reason": run.failure_reason}
            return float(mc.compute_accuracy(Xt, yt, run.chains.reshape(-1, K * d), K))
        wts = torch.from_numpy(np.asarray(wts, np.float32)).to(dev)
        pts = torch.from_numpy(np.atleast_2d(np.asarray(pts, np.float32))).to(dev)
        lap = newton_laplace(lambda th: lj(pts, th, wts), lambda th: g_of(pts, th, wts),
                             lambda th: h_of(pts, th, wts),
                             torch.zeros(K * d, device=dev), n_iters=25)
        z = torch.randn((256, K * d), generator=keyed(args, 99), device=dev)
        return float(mc.compute_accuracy(Xt, yt, sample_laplace_from_noise(lap, z), K))

    sizes, accs = [], []
    # always evaluate the final size
    eval_sizes = sorted(set(range(args.eval_every, len(snaps) + 1, args.eval_every))
                        | {len(snaps)})
    for m in eval_sizes:
        w, p = snaps[m - 1]
        a = acc_of(w, p, m)
        sizes.append(m)
        accs.append(a)
        print(f"m={m:4d}  acc={a:.4f}")
    print(f"{args.alg}: build {t_build:.1f}s, final acc {accs[-1]:.4f} (base {base:.4f})")

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"mc_{args.dataset}_K{K}_{args.alg}_{args.f_rate}_{args.trial}"
    if args.dedup_select:
        tag += "_dedup"
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "sizes": sizes, "accs": accs,
                     "build_s": t_build, "base": base,
                     "select_beta": select_record,
                     "mcmc_escalations": escalations}, fh)
    return out


if __name__ == "__main__":
    main()
