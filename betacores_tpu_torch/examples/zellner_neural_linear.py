"""Neural-linear batch active-learning experiment, through the port
(counterpart of examples/zellner_neural_linear.py).

An encoder under an exact Bayesian last layer; the data in random groups,
a fraction of the groups corrupted; a {BCORES, SVI, RAND} group-mode
coreset warm-started from an initial batch, coreset iterations interleaved
with retraining the encoder on the current weighted coreset; the test RMSE
and predictive NLL after every iteration.

Usage: python -m betacores_tpu_torch.examples.zellner_neural_linear --alg BCORES --trial 1
"""

import argparse
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.data import gen_synthetic_linreg, perturb_groups
from betacores_tpu_torch.data.loaders import make_random_groups, standardize
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed
from betacores_tpu_torch.models.neural_linear import (NeuralLinear,
                                                      neural_linear_model_factory,
                                                      neural_linear_sampler_factory)

ALGS = ["BCORES", "SVI", "RAND", "PRIOR"]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--dataset", default="synth",
                    help="synth (the generator), a regression npz resolvable by "
                         "reference_dataset_path (e.g. movielens5, star ratings 1-5 "
                         "as regression), or a UCI name boston / news / year / "
                         "prices2018 (a local raw file; never fetched)")
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--N", type=int, default=2000,
                    help="train rows (real datasets: subsampled without replacement "
                         "if smaller than the file; 0 = all)")
    ap.add_argument("--D", type=int, default=12)
    ap.add_argument("--M", type=int, default=20, help="coreset iterations (batches)")
    ap.add_argument("--batch-size", type=int, default=20, help="group size")
    ap.add_argument("--init-size", type=int, default=20)
    ap.add_argument("--out-features", type=int, default=30)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=500)
    ap.add_argument("--n-subsample-opt", type=int, default=1000)
    ap.add_argument("--i0", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.5)
    ap.add_argument("--select-beta", action="store_true",
                    help="pick beta by the trimmed held-out predictive criterion: per "
                         "candidate a fresh encoder and a short acquisition loop "
                         "(--select-M rounds), scored on a held-out slice of the "
                         "corrupted train rows (BCORES only)")
    ap.add_argument("--beta-grid", default="0.01,0.1,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.2)
    ap.add_argument("--select-M", type=int, default=0,
                    help="acquisition rounds per candidate (0 = max(3, M/4))")
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--nn-epochs", type=int, default=200)
    ap.add_argument("--initial-lr", type=float, default=1e-2)
    ap.add_argument("--weight-decay", type=float, default=1e-1)
    ap.add_argument("--train-nn-freq", type=int, default=1)
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(args.trial)

    if args.dataset == "synth":
        X, Y, _ = gen_synthetic_linreg(keyed(args, args.trial, device="cpu"),
                                       N=args.N + 1500, D=args.D)
        X, Y = host(X), host(Y)
        X, Xt = X[: args.N], X[args.N:]
        Y, Yt = Y[: args.N], Y[args.N:]
    elif args.dataset in ("boston", "news", "year", "prices2018"):
        from betacores_tpu_torch.data.loaders import load_uci_regression

        X, Y = load_uci_regression(args.dataset)
        perm = rng.permutation(X.shape[0])
        n_te = max(1, int(0.2 * X.shape[0]))
        X, Y = X[perm].astype(np.float64), Y[perm].astype(np.float64)
        Xt, Yt = X[:n_te], Y[:n_te]
        X, Y = X[n_te:], Y[n_te:]
        if args.N and args.N < X.shape[0]:
            X, Y = X[: args.N], Y[: args.N]
        print(f"dataset {args.dataset}: N={X.shape[0]} d={X.shape[1]} "
              f"test={Xt.shape[0]} (y in [{Y.min():.3g}, {Y.max():.3g}])")
    else:
        from betacores_tpu_torch.data.loaders import load_npz, reference_dataset_path

        path = reference_dataset_path(args.dataset)
        if path is None:
            raise SystemExit(f"dataset {args.dataset!r} not found (searched "
                             f"$BETACORES_DATA and the repo's data/)")
        X, Y, Xt, Yt = load_npz(path)
        if args.dataset.startswith("movielens"):
            Y, Yt = Y + 1.0, Yt + 1.0  # star buckets 0..4 -> 1..5 stars
        if args.N and args.N < X.shape[0]:
            sel = rng.choice(X.shape[0], args.N, replace=False)
            X, Y = X[sel], Y[sel]
        Y, Yt = Y[:, None], Yt[:, None]
        print(f"dataset {args.dataset}: N={X.shape[0]} d={X.shape[1]} "
              f"test={Xt.shape[0]} (y in [{Y.min():.3g}, {Y.max():.3g}])")
    Xi, Yi = X[: args.init_size].copy(), Y[: args.init_size].copy()
    X, Y, Xi, Yi, Xt, Yt, in_m, in_s, out_m, out_s = standardize(X, Y, Xi, Yi, Xt, Yt)

    groups = make_random_groups(rng, X.shape[0], args.batch_size)
    X, Y = perturb_groups(args.trial + 1 + 1_000_003 * args.seed, X, Y, groups,
                          f_rate=args.f_rate)
    Z = np.hstack([X, Y]).astype(np.float32)
    Z_init = np.hstack([Xi, Yi]).astype(np.float32)
    Z_test = np.hstack([Xt, Yt]).astype(np.float32)[:1000]

    datamn, datastd = float(np.mean(Y)), float(np.std(Y))
    sigsq = max(datastd ** 2, 1e-3)
    F = args.out_features
    mu0 = datamn * torch.ones(F)
    Sig0inv = torch.linalg.inv((datastd ** 2 + datamn ** 2) * torch.eye(F))

    nl = NeuralLinear(Z_init, out_features=F, output_mean=out_m, output_std=out_s,
                      sigmasq=sigsq, seed=args.trial, device=dev)
    model_factory = neural_linear_model_factory(nl.module, sigsq)
    sampler_factory = neural_linear_sampler_factory(nl.module, mu0, Sig0inv, sigsq)
    prj = bc.coresets.ContextualProjector(sampler_factory, args.proj_dim, model_factory)

    sched = lambda i: args.i0 / (1.0 + i)
    init_kw = dict(wts=np.ones(args.init_size), idcs=10_000_000 + np.arange(args.init_size),
                   pts=Z_init, groups=groups, initialized=True)
    N = Z.shape[0]
    Zd = torch.from_numpy(Z).to(dev)

    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu_torch.coresets.select_beta import select_beta
        from betacores_tpu_torch.models.neural_linear import gaussian_log_density

        # score on a random slice of the corrupted train rows; the trimmed
        # mean drops the contaminated tail
        rng_sel = np.random.default_rng(args.trial * 7 + 1)
        ho = rng_sel.choice(Z.shape[0], max(1, Z.shape[0] // 6), replace=False)
        Zho = torch.from_numpy(Z[ho]).to(dev)
        M_sel = args.select_M or max(3, args.M // 4)
        sel_epochs = max(20, args.nn_epochs // 4)
        holder = {}

        def build_fn(b):
            nl_b = NeuralLinear(Z_init, out_features=F, output_mean=out_m, output_std=out_s,
                                sigmasq=sigsq, seed=args.trial, device=dev)
            alg_b = bc.BetaCoreset(Zd, prj, beta=b, learn_beta=False, opt_itrs=args.opt_itrs,
                                   n_subsample_opt=args.n_subsample_opt, step_sched=sched,
                                   seed=args.trial, device=dev, **init_kw)
            wts = pts = None
            for _ in range(M_sel):
                alg_b.ctx = nl_b.variables
                alg_b.build(1, N + args.init_size)
                wts, pts = alg_b.get()[:2]
                nl_b.update_batch(pts.astype(np.float32))
                nl_b.optimize(wts.astype(np.float32), pts.astype(np.float32),
                              num_epochs=sel_epochs, initial_lr=args.initial_lr,
                              weight_decay=args.weight_decay)
            holder["nl"] = nl_b
            return wts, pts

        def score_fn(wts, pts):
            # per-point predictive log-density under the candidate's posterior
            mean, var = holder["nl"].forward(Zho[:, :-1])
            return host(gaussian_log_density(Zho[:, -1:], mean, var)).ravel()

        grid = [float(b) for b in args.beta_grid.split(",")]
        t_sel0 = time.perf_counter()
        best_beta, scores = select_beta(build_fn, grid, score_fn, trim=args.select_trim)
        t_sel = time.perf_counter() - t_sel0
        select_record = {"grid": grid, "scores": [float(s) for s in scores],
                         "beta": best_beta, "trim": args.select_trim, "select_time_s": t_sel}
        print("select-beta grid: " + "  ".join(f"{b:g}:{s:.4f}" for b, s in zip(grid, scores)))
        print(f"selected beta = {best_beta:g} [{t_sel:.1f}s, {M_sel} rounds per candidate]")
        args.beta = best_beta

    common = dict(opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
                  step_sched=sched, seed=args.trial, device=dev, **init_kw)
    if args.alg == "BCORES":
        alg = bc.BetaCoreset(Zd, prj, beta=args.beta, learn_beta=False, **common)
    elif args.alg == "SVI":
        alg = bc.SparseVICoreset(Zd, prj, **common)
    elif args.alg == "RAND":
        alg = bc.UniformSamplingCoreset(Zd, seed=args.trial, groups=groups,
                                        wts=np.ones(args.init_size),
                                        idcs=10_000_000 + np.arange(args.init_size),
                                        pts=Z_init, device=dev)
    else:
        alg = None

    nlls, rmses = np.zeros(args.M + 1), np.zeros(args.M + 1)
    nlls[0], rmses[0] = nl.test(Z_test)
    print(f"m=0 nll={nlls[0]:.4f} rmse={rmses[0]:.4f}")

    t0 = time.perf_counter()
    for m in range(1, args.M + 1):
        if alg is None:
            nlls[m], rmses[m] = nlls[0], rmses[0]
            continue
        if hasattr(alg, "ctx"):
            alg.ctx = nl.variables
        alg.build(1, N + args.init_size)
        wts, pts = alg.get()[:2]
        nl.update_batch(pts.astype(np.float32))
        if m % args.train_nn_freq == 0:
            nl.optimize(wts.astype(np.float32), pts.astype(np.float32),
                        num_epochs=args.nn_epochs, initial_lr=args.initial_lr,
                        weight_decay=args.weight_decay)
        nlls[m], rmses[m] = nl.test(Z_test)
        print(f"m={m} coreset_pts={len(wts)} nll={nlls[m]:.4f} rmse={rmses[m]:.4f}")
    total = time.perf_counter() - t0

    os.makedirs(args.results_dir, exist_ok=True)
    tag = (f"{args.dataset}_{args.alg}_frate_{args.f_rate}_beta_{args.beta}_i0_{args.i0}_"
           f"{args.trial}")
    out = os.path.join(args.results_dir, f"results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "rmses": rmses, "nlls": nlls,
                     "time_s": total, "select_beta": select_record}, fh)
    print(f"done in {total:.1f}s; rmse {rmses[0]:.3f} -> {rmses[args.M]:.3f}")
    return out


if __name__ == "__main__":
    main()
