"""Group selection and data valuation: beta-Cores against distributional
and truncated Monte-Carlo Shapley and random group selection, through the
port (counterpart of examples/group_selection.py).

Demographic groups of a logistic-regression dataset (the
``vq_groups_sensemake_*`` pickle when the dataset has one, else
synthesized), group-level corruption in proportion to a demographic
fraction, a rebalanced test set, then group selection by group-mode
beta-Cores, Shapley ranking or at random; every prefix of the selected
group sequence is scored by the Laplace posterior's test accuracy.

Usage: python -m betacores_tpu_torch.examples.group_selection --alg BCORES --trial 0
"""

import argparse
import math
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.coresets import group_ids_from_groups
from betacores_tpu_torch.data import gen_synthetic_logreg
from betacores_tpu_torch.data.loaders import (groups_pickle_path, load_groups_pickle, load_npz,
                                              reference_dataset_path, std_cov)
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed, sync
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from betacores_tpu_torch.ops.projection import Groups
from betacores_tpu_torch.valuation import (logreg_laplace_value_fn, make_dshapley,
                                           make_tmc_shapley)

ALGS = ["BCORES", "DShapley", "TMC", "RAND"]


def rebalance_test(Xt, Yt, rnd):
    """Truncate the majority label for a balanced test set."""
    n_pos = (Yt == 1).sum()
    if 0.45 * len(Yt) <= n_pos <= 0.55 * len(Yt):
        return Xt, Yt
    maj = 1.0 if n_pos > len(Yt) - n_pos else -1.0
    keep_min = np.where(Yt == -maj)[0]
    n_keep = len(keep_min) + int(0.01 * len(keep_min) * rnd)
    keep_maj = np.where(Yt == maj)[0][:n_keep]
    idcs = np.concatenate([keep_maj, keep_min])
    return Xt[idcs], Yt[idcs]


def load_problem(args):
    """(Z, X, Y, Xt, Yt, groups) as numpy arrays and lists: the dataset
    with its groups pickle, or the synthetic fallback (a dataset the repo
    lacks is never fetched)."""
    path = reference_dataset_path(args.dataset)
    gpath = None if path is None else groups_pickle_path(args.dataset, dataset_path=path)
    if path is not None and gpath is not None:
        X, Y, Xt, Yt = load_npz(path)
        X, Y, Z, mean_, cov_ = std_cov(X, Y)
        groups, demos = load_groups_pickle(gpath)
        groups = [[k for k in g if k < Z.shape[0]] for g in groups]
    else:
        # synthetic fallback with demographic-like groups; mean 0 keeps the
        # classes balanced, so the rebalancing keeps the test set
        gen = keyed(args, args.trial + 11, device="cpu")
        X, Y, Z = (host(a).copy() for a in gen_synthetic_logreg(gen, 3000, d=8, mean_val=0.0))
        Xt, Yt, _ = (host(a).copy() for a in gen_synthetic_logreg(gen, 800, d=8, mean_val=0.0))
        rng = np.random.default_rng(args.trial)
        perm = rng.permutation(X.shape[0])
        sizes = rng.integers(50, 300, size=100)
        groups, i = [], 0
        for s in sizes:
            if i + s > len(perm):
                break
            groups.append(perm[i: i + s].tolist())
            i += s
        demos = [(rng.uniform(), g) for g in groups]
        mean_ = cov_ = None
    # group-level corruption in proportion to the demographic fraction
    rng = np.random.default_rng(args.trial)
    for g, dem in zip(groups, demos):
        frac = (dem[0] if isinstance(dem, tuple) else
                float(np.atleast_1d(np.asarray(dem, dtype=object)[0]).astype(float)[0]))
        o = int(len(g) * min(frac * args.f_rate * 3, 0.9))
        if o > 0:
            rows = rng.choice(g, size=o, replace=False)
            cols = rng.choice(X.shape[1], max(X.shape[1] // 2, 1), replace=False)
            for c in cols:
                X[rows, c] = rng.normal(0, 10, size=o)
            Y[rows] = -Y[rows]
    Z = Y[:, None] * X
    rnd = np.random.default_rng(42).uniform()
    Xt, Yt = rebalance_test(Xt, Yt, rnd)
    if mean_ is not None:
        Xt, Yt, _, _, _ = std_cov(Xt, Yt, mean_, cov_)
    return (Z.astype(np.float32), X.astype(np.float32), Y.astype(np.float32),
            Xt.astype(np.float32), Yt.astype(np.float32), groups)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", choices=ALGS, default="BCORES")
    ap.add_argument("--dataset", default="diabetes")
    ap.add_argument("--trial", type=int, default=0)
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--M", type=int, default=10, help="number of groups to select")
    ap.add_argument("--beta", type=float, default=0.2)
    ap.add_argument("--select-beta", action="store_true",
                    help="pick beta by the trimmed held-out predictive criterion over "
                         "group-mode builds before the reported selection (BCORES only)")
    ap.add_argument("--beta-grid", default="0.01,0.05,0.1,0.2,0.3,0.5,0.7,1.0")
    ap.add_argument("--select-trim", type=float, default=0.25)
    ap.add_argument("--select-M", type=int, default=0,
                    help="groups per selection build (0 = --M)")
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=200)
    ap.add_argument("--n-subsample-opt", type=int, default=500)
    ap.add_argument("--refit-every", type=int, default=1,
                    help="lagged Laplace refits in the Adam loop")
    ap.add_argument("--dedup-select", action="store_true",
                    help="mask already-selected groups out of the candidate argmax")
    ap.add_argument("--shapley-T", type=int, default=50)
    ap.add_argument("--shapley-cap", type=int, default=50)
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    Z, X, Y, Xt, Yt, groups = load_problem(args)
    G = len(groups)
    print(f"N={Z.shape[0]} d={Z.shape[1]} groups={G} test={len(Yt)}")
    Zd, Xtd, Ytd = (torch.from_numpy(a).to(dev) for a in (Z, Xt, Yt))
    value_fn = logreg_laplace_value_fn(n_samples=256)
    value_args = (Zd, Xtd, Ytd)

    def value(seed, mask):
        return value_fn(value_fn.draw(keyed(args, seed), *value_args), mask, *value_args)

    group_kw = dict(opt_itrs=args.opt_itrs, n_subsample_select=None,
                    n_subsample_opt=args.n_subsample_opt, groups=groups, seed=args.trial,
                    refit_every=args.refit_every, dedup_select=args.dedup_select, device=dev)
    select_record = None
    if args.select_beta:
        if args.alg != "BCORES":
            raise SystemExit("--select-beta only applies to BCORES")
        from betacores_tpu_torch.coresets.select_beta import driver_select_beta, padded_scorer

        smp_s = logreg_laplace_sampler()
        prj_s = bc.BetaBlackBoxProjector(smp_s, args.proj_dim, model=logreg.bundle())
        # candidate builds run group mode on the whole corrupted data, scored
        # on a random row slice by the trimmed per-point predictive log-lik
        rng_sel = np.random.default_rng(args.trial * 7 + 1)
        ho = rng_sel.choice(Z.shape[0], max(1, Z.shape[0] // 6), replace=False)
        Zho = torch.from_numpy(Z[ho]).to(dev)
        M_sel = args.select_M or args.M
        alg_sel = bc.BetaCoreset(Zd, prj_s, beta=args.beta, learn_beta=False, **group_kw)
        S_score = 256
        d_feat = Z.shape[1]

        def _pred_ll(wm, pm):
            samples, _ = smp_s(keyed(args, args.trial * 31 + 5), S_score, wm, pm,
                               torch.zeros(d_feat, device=dev))
            ll = logreg.log_likelihood(Zho, samples)
            return torch.logsumexp(ll, dim=1) - math.log(S_score)

        # a group build appends whole groups: the padded scorer holds the
        # largest possible selection
        cap_rows = int(M_sel * max(len(g) for g in groups))
        score_fn = padded_scorer(cap_rows, d_feat, _pred_ll, device=dev)
        grid = [float(b) for b in args.beta_grid.split(",")]
        best_beta, select_record, _ = driver_select_beta(alg_sel, grid, score_fn,
                                                         args.select_trim, M_sel)
        print("select-beta grid: " + "  ".join(
            f"{b:g}:{s:.4f}" for b, s in zip(grid, select_record["scores"])))
        print(f"selected beta = {best_beta:g} "
              f"[{select_record['select_time_s']:.1f}s for {len(grid)} group-mode builds]")
        args.beta = best_beta

    sync(dev)
    t0 = time.perf_counter()
    if args.alg == "BCORES":
        prj = bc.BetaBlackBoxProjector(logreg_laplace_sampler(), args.proj_dim,
                                       model=logreg.bundle())
        alg = bc.BetaCoreset(Zd, prj, beta=args.beta, learn_beta=False, **group_kw)
        # an iteration may re-weight without adding a group: iterate until M
        # distinct groups are selected (at most 4M iterations), M at a time,
        # the order read off the recorded selected masks
        order = []
        prev = np.zeros(G, dtype=bool)
        for _ in range(4):
            _, sel = alg.build_trace(args.M, return_selected=True)
            for row in sel:
                order.extend(np.where(row & ~prev)[0].tolist())
                prev = row
            if len(order) >= args.M:
                break
        order = order[: args.M]
    elif args.alg == "DShapley":
        gp = Groups.from_lists(groups, dev)
        gid = group_ids_from_groups(gp, Z.shape[0])
        dshap = make_dshapley(gid, gp, value_fn, value_args=value_args,
                              max_groups=min(20, G), group_cap=args.shapley_cap)
        phis = host(dshap(keyed(args, args.trial), args.shapley_T))
        order = np.argsort(phis)[::-1][: args.M].tolist()
    elif args.alg == "TMC":
        gp = Groups.from_lists(groups, dev)
        gid = group_ids_from_groups(gp, Z.shape[0])
        full_value = float(value(999, (gid < G).to(torch.float32)))
        print(f"full-data value (TMC truncation target): {full_value:.4f}")
        tmc = make_tmc_shapley(gid, gp, value_fn, value_args=value_args,
                               full_value=full_value, group_cap=args.shapley_cap)
        phis = host(tmc(keyed(args, args.trial), args.shapley_T))
        order = np.argsort(phis)[::-1][: args.M].tolist()
    else:
        order = np.random.default_rng(args.trial).permutation(G)[: args.M].tolist()
    sync(dev)
    select_time = time.perf_counter() - t0

    # every prefix of the selected group sequence
    accs = np.zeros(len(order) + 1)
    accs[0] = 0.5
    mask = np.zeros(Z.shape[0], dtype=bool)
    for j, g in enumerate(order, start=1):
        mask[groups[g]] = True
        accs[j] = float(value(1000 + j, torch.from_numpy(mask.astype(np.float32)).to(dev)))
        print(f"prefix {j} (group {g}, {mask.sum()} pts): acc={accs[j]:.4f}")

    os.makedirs(args.results_dir, exist_ok=True)
    tag = f"{args.dataset}_{args.alg}_{args.f_rate}_{args.trial}"
    out = os.path.join(args.results_dir, f"group_results_{tag}.pk")
    with open(out, "wb") as fh:
        pickle.dump({"args": vars(args), "order": order, "accs": accs,
                     "select_time_s": select_time, "select_beta": select_record}, fh)
    print(f"{args.alg}: selection {select_time:.1f}s, final acc {accs[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
