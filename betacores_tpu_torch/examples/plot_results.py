"""Plot experiment results pickles, through the port's plotting kit
(counterpart of examples/plot_results.py): median+IQR KL / accuracy / NLL /
RMSE against coreset size across trials, per algorithm. Reads the pickles of
either implementation's drivers (they write the same files).

Usage:
  python -m betacores_tpu_torch.examples.plot_results --kind gaussian --results-dir results --out kl.png
  python -m betacores_tpu_torch.examples.plot_results --kind logreg --results-dir results --out acc.png
"""

import argparse
import glob
import os
import pickle
from collections import defaultdict

import numpy as np

# the logreg driver's defaults of the swept flags: a pickle written before a
# flag existed counts as that flag's default in the modal-config filter
LOGREG_DEFAULTS = {"f_rate": 0.1, "i0": 1.0, "graddiag": False, "beta": 0.1,
                   "dedup_select": False}


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from betacores_tpu_torch.plotting import plot_curves

    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["gaussian", "logreg", "neural_linear", "groups",
                                       "housing", "poisson", "multiclass"],
                    default="gaussian")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--metric", default=None,
                    help="gaussian: rklw|fklw; logreg: accs|plls; neural_linear: rmses|nlls")
    ap.add_argument("--out", default="plot.png")
    ap.add_argument("--filter", default=None,
                    help="only include results files whose basename contains "
                         "this substring (tags are config-encoding, so e.g. "
                         "'_0.1_' slices one f_rate, '_gd' the graddiag runs)")
    args = ap.parse_args(argv)

    def _glob(pattern):
        paths = glob.glob(pattern)
        if args.filter is not None:
            paths = [p for p in paths if args.filter in os.path.basename(p)]
        return paths

    if args.kind == "housing":
        # lat/lon scatter colored by log price
        data = np.load(os.path.join(args.results_dir, "prices2018.npy"))
        data = data[np.argsort(data[:, 2])]
        logp = np.log(data[:, 2])
        c = ((logp - logp.min()) / max(logp.max() - logp.min(), 1e-12)) ** 3
        fig, ax = plt.subplots(figsize=(6, 7))
        ax.scatter(data[:, 1], data[:, 0], c=c, cmap="coolwarm", s=2,
                   alpha=0.05, linewidths=0)
        ax.set_xlabel("longitude"); ax.set_ylabel("latitude")
        fig.tight_layout(); fig.savefig(args.out, dpi=150)
        print(f"saved {args.out} ({data.shape[0]} sales)")
        return args.out

    curves = defaultdict(list)
    xs = None  # eval sizes for dict-keyed metrics (indices otherwise)
    xs_list = []
    if args.kind == "gaussian":
        metric = args.metric or "rklw"
        for path in _glob(os.path.join(args.results_dir, "results_*.pk")):
            with open(path, "rb") as f:
                res = pickle.load(f)
            if isinstance(res, dict) and metric in res:
                curves[res["alg"]].append(np.asarray(res[metric]))
        ylabel, log_y = ("reverse KL" if metric == "rklw" else "forward KL"), True
    elif args.kind == "logreg":
        metric = args.metric or "accs"
        loaded = []
        for path in _glob(os.path.join(args.results_dir, "results_*.pk")):
            # other experiment families share the prefix and (for plls) the
            # schema: mixing them in would average across experiments
            if os.path.basename(path).startswith(("results_poiss_",
                                                  "results_mc_",
                                                  "results_dpbpsvi_")):
                continue
            with open(path, "rb") as f:
                res = pickle.load(f)
            if isinstance(res, dict) and metric in res and isinstance(res.get(metric), dict):
                loaded.append(res)
        # one band must never average over different hyperparameter configs
        # (the sweep grids add i0/graddiag/f_rate axes whose pickles share a
        # directory): keep only the modal (f_rate, i0, graddiag, beta, dedup)
        # combo, a missing key read as the driver's default, and say what was
        # dropped. --filter still selects any slice explicitly.
        def _cfg(res):
            a = res.get("args", {})
            return tuple((k, a.get(k, v)) for k, v in LOGREG_DEFAULTS.items())
        if loaded:
            combos = [_cfg(r) for r in loaded]
            modal = max(set(combos), key=combos.count)
            dropped = sum(c != modal for c in combos)
            if dropped:
                print(f"WARNING: {dropped}/{len(loaded)} results files use a "
                      f"different hyperparameter config than the modal "
                      f"{dict(modal)}; dropped from the bands (use --filter "
                      f"to slice another config)")
            loaded = [r for r, c in zip(loaded, combos) if c == modal]
        for res in loaded:
            ms = sorted(res[metric])
            xs_list.append(np.asarray(ms))
            xs = xs_list[-1]
            curves[res["args"]["alg"]].append(np.asarray([res[metric][m] for m in ms]))
        ylabel, log_y = ("accuracy" if metric == "accs" else "predictive LL"), False
    elif args.kind == "poisson":
        metric = args.metric or "plls"
        for path in _glob(os.path.join(args.results_dir, "results_poiss_*.pk")):
            with open(path, "rb") as f:
                res = pickle.load(f)
            if isinstance(res, dict) and isinstance(res.get(metric), dict):
                ms = sorted(res[metric])
                xs_list.append(np.asarray(ms))
                xs = xs_list[-1]
                curves[res["args"]["alg"]].append(np.asarray([res[metric][m] for m in ms]))
        ylabel, log_y = "test predictive LL", False
    elif args.kind == "multiclass":
        for path in _glob(os.path.join(args.results_dir, "results_mc_*.pk")):
            with open(path, "rb") as f:
                res = pickle.load(f)
            if isinstance(res, dict) and "accs" in res:
                xs = np.asarray(res["sizes"])
                curves[res["args"]["alg"]].append(np.asarray(res["accs"]))
        ylabel, log_y = "test accuracy", False
    elif args.kind == "neural_linear":
        metric = args.metric or "rmses"
        for path in _glob(os.path.join(args.results_dir, "results_*.pk")):
            with open(path, "rb") as f:
                res = pickle.load(f)
            if isinstance(res, dict) and metric in res:
                curves[res["args"]["alg"]].append(np.asarray(res[metric]))
        ylabel, log_y = metric, False
    else:
        for path in _glob(os.path.join(args.results_dir, "group_results_*.pk")):
            with open(path, "rb") as f:
                res = pickle.load(f)
            curves[res["args"]["alg"]].append(np.asarray(res["accs"]))
        ylabel, log_y = "accuracy", False

    if not curves:
        print("no results found")
        return None
    # truncate every curve (and the x grid) to one global minimum length:
    # per-alg truncation with a last-file x grid could pair one run's values
    # with another run's coreset sizes, or crash on a length mismatch
    L = min(len(c) for v in curves.values() for c in v)
    for k in curves:
        curves[k] = np.stack([c[:L] for c in curves[k]])
    fig, ax = plt.subplots(figsize=(6, 4))
    if xs is not None:
        if xs_list:
            xs = xs_list[0]
            for other in xs_list[1:]:
                if not np.array_equal(other[:L], xs[:L]):
                    print("WARNING: results files use different evaluation "
                          "grids; plotting against the first file's sizes")
                    break
        xs = xs[:L]
    plot_curves(ax, curves, x=xs, ylabel=ylabel, log_y=log_y)
    fig.tight_layout()
    fig.savefig(args.out, dpi=150)
    print(f"saved {args.out} ({ {k: v.shape for k, v in curves.items()} })")
    return args.out


if __name__ == "__main__":
    main()
