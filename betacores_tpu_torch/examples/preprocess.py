"""Dataset preprocessing, through the port (counterpart of
examples/preprocess.py; the reference's examples/data/preproc_*.py
consolidated).

Operates on locally present raw files (nothing is fetched; the reference
scripts download from UCI). Every subcommand writes the JAX script's files,
with the same names and the same arrays, bit for bit, from the same raw
files; the numpy helpers (``pca_fit_transform``, ``one_hot``,
``quality_split_groups``, ``postcode_to_int``) are the port's own copies.
The tables of adult, diabetes and movielens are read with pandas, as the
JAX script reads them. Subcommands:

  adult      ADULT income: encode, whiten, build demographic groups
             (age x race x gender product, capped; 'vq' quality-split
             variant) -> adult.npz + vq_groups_sensemake_adult.pk
             (reference preproc_adult.py)
  diabetes   Diabetes readmissions: encode + groups (preproc_diabetes.py)
  phishing   One-hot + PCA(10) + intercept -> phishing.npz
             (preproc_phishing.py)
  webspam    svmlight -> subsample/PCA/offset -> webspam.npz
             (preproc_webspam.py; uses the native C++ parser)
  covtype    csv/npz -> binary task + options -> covtype.npz
             (preproc_covtype.py)
  mnist2     MNIST npz -> binary {-1,+1} task (convert_mnist_to_2class.py)
  movielens  MovieLens ratings -> binary and 5-class tasks + per-user groups
  housing    UK price-paid x GB postcode geocoding -> prices2018.npy

Usage: python -m betacores_tpu_torch.examples.preprocess <subcommand> --raw <file(s)> --out-dir data/
"""

import argparse
import itertools
import os
import pickle
import sys

import numpy as np

from betacores_tpu_torch.data.native_loader import load_csv, load_svmlight


def pca_fit_transform(X: np.ndarray, n_components: int) -> np.ndarray:
    """Numpy PCA (the reference uses sklearn.decomposition.PCA)."""
    Xc = X - X.mean(axis=0)
    _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
    return Xc @ Vt[:n_components].T


def one_hot(X: np.ndarray) -> np.ndarray:
    cols = []
    for j in range(X.shape[1]):
        vals = np.unique(X[:, j])
        cols.append((X[:, j][:, None] == vals[None, :]).astype(np.float64))
    return np.hstack(cols)


def add_intercept(X):
    return np.c_[X, np.ones(X.shape[0])]


def quality_split_groups(member_lists, cap: int = 100, n_quality: int = 3):
    """The reference's 'vq' variant (preproc_adult.py:33-48): split each
    demographic cell into n_quality consecutive slices of up to ``cap``."""
    groups, tags = [], []
    for q in range(n_quality):
        for tag, ng in member_lists:
            if len(ng) >= n_quality * cap:
                sl = ng[q * cap:(q + 1) * cap]
            else:
                sl = ng[int(q * len(ng) / n_quality):int((q + 1) * len(ng) / n_quality)]
            if sl:
                groups.append(list(sl))
                tags.append((q,) + tag)
    return groups, tags


def cmd_adult(args):
    import pandas as pd

    cols = ["age", "workclass", "fnlwgt", "education", "education-num",
            "marital-status", "occupation", "relationship", "race", "sex",
            "capital-gain", "capital-loss", "hours-per-week", "native-country", "income"]
    df = pd.read_csv(args.raw[0], names=cols, skipinitialspace=True, comment="|")
    df = df.replace("?", np.nan).dropna().reset_index(drop=True)
    y = np.where(df["income"].str.contains(">50K"), 1.0, -1.0)
    num = df[["age", "education-num", "capital-gain", "capital-loss", "hours-per-week"]].to_numpy(float)
    num = (num - num.mean(0)) / (num.std(0) + 1e-12)
    cat = one_hot(df[["workclass", "marital-status", "occupation", "race", "sex"]].to_numpy(str))
    X = add_intercept(np.hstack([num, pca_fit_transform(cat, min(5, cat.shape[1]))]))
    np.savez(os.path.join(args.out_dir, "adult.npz"), X=X, y=y, Xt=np.zeros(0), yt=np.zeros(0))

    # demographic groups (reference preproc_adult.py:20-48)
    ages = [(0, 25), (25, 30), (30, 35), (35, 40), (40, 45), (45, 55), (55, int(df["age"].max()))]
    races = sorted(set(df["race"]) - {"Other", "Asian-Pac-Islander", "Amer-Indian-Eskimo"})
    genders = sorted(set(df["sex"]))
    cells = []
    for a, r, g in itertools.product(ages, races, genders):
        ng = df.index[(df["race"] == r) & (df["sex"] == g)
                      & (a[0] < df["age"]) & (df["age"] <= a[1])].tolist()
        cells.append((((a, r, g)), ng))
    groups, tags = quality_split_groups(cells, cap=args.cap)
    with open(os.path.join(args.out_dir, "vq_groups_sensemake_adult.pk"), "wb") as f:
        pickle.dump((groups, tags), f)
    print(f"adult: N={X.shape[0]} d={X.shape[1]} groups={len(groups)}")


def cmd_diabetes(args):
    import pandas as pd

    df = pd.read_csv(args.raw[0]).replace("?", np.nan)
    df = df.dropna(subset=["race", "gender", "age"]).reset_index(drop=True)
    y = np.where(df["readmitted"].astype(str) != "NO", 1.0, -1.0)
    num_cols = [c for c in ["time_in_hospital", "num_lab_procedures", "num_procedures",
                            "num_medications", "number_outpatient", "number_emergency",
                            "number_inpatient", "number_diagnoses"] if c in df]
    num = df[num_cols].to_numpy(float)
    num = (num - num.mean(0)) / (num.std(0) + 1e-12)
    X = add_intercept(num)
    np.savez(os.path.join(args.out_dir, "diabetes.npz"), X=X, y=y, Xt=np.zeros(0), yt=np.zeros(0))

    cells = []
    for a, r, g in itertools.product(sorted(set(df["age"])), sorted(set(df["race"])),
                                     sorted(set(df["gender"]))):
        ng = df.index[(df["race"] == r) & (df["gender"] == g) & (df["age"] == a)].tolist()
        if len(ng) > 40:  # reference preproc_diabetes.py:18
            cells.append((((a, r, g)), ng))
    groups, tags = quality_split_groups(cells, cap=args.cap)
    with open(os.path.join(args.out_dir, "vq_groups_sensemake_diabetes.pk"), "wb") as f:
        pickle.dump((groups, tags), f)
    print(f"diabetes: N={X.shape[0]} d={X.shape[1]} groups={len(groups)}")


def cmd_phishing(args):
    data = load_csv(args.raw[0], skip_header=1)
    X, y = data[:, :-1], data[:, -1]
    X = add_intercept(pca_fit_transform(one_hot(X), 10))
    np.savez(os.path.join(args.out_dir, "phishing.npz"), X=X, y=y, Xt=np.zeros(0), yt=np.zeros(0))
    print(f"phishing: N={X.shape[0]} d={X.shape[1]}")


def cmd_webspam(args):
    X, y = load_svmlight(args.raw[0])
    if args.subsample and args.subsample < X.shape[0]:
        idx = np.random.default_rng(0).choice(X.shape[0], args.subsample, replace=False)
        X, y = X[idx], y[idx]
    if args.pca:
        X = pca_fit_transform(X, args.pca)
    X = add_intercept(X)
    y = np.where(y > 0, 1.0, -1.0)
    np.savez(os.path.join(args.out_dir, "webspam.npz"), X=X, y=y, Xt=np.zeros(0), yt=np.zeros(0))
    print(f"webspam: N={X.shape[0]} d={X.shape[1]}")


def cmd_covtype(args):
    data = load_csv(args.raw[0])
    X, y = data[:, :-1], data[:, -1]
    y = np.where(y == 2, 1.0, -1.0)  # majority class vs rest (binary task)
    if args.subsample and args.subsample < X.shape[0]:
        idx = np.random.default_rng(0).choice(X.shape[0], args.subsample, replace=False)
        X, y = X[idx], y[idx]
    if args.pca:
        X = pca_fit_transform(X, args.pca)
    X = add_intercept(X)
    np.savez(os.path.join(args.out_dir, "covtype.npz"), X=X, y=y, Xt=np.zeros(0), yt=np.zeros(0))
    print(f"covtype: N={X.shape[0]} d={X.shape[1]}")


def cmd_mnist2(args):
    data = np.load(args.raw[0])
    X, y = data["X"], data["y"]
    keep = (y == args.a) | (y == args.b)
    X, y = X[keep], np.where(y[keep] == args.a, 1.0, -1.0)
    np.savez(os.path.join(args.out_dir, "mnist2.npz"), X=add_intercept(X / 255.0), y=y,
             Xt=np.zeros(0), yt=np.zeros(0))
    print(f"mnist2 ({args.a} vs {args.b}): N={X.shape[0]}")


def cmd_movielens(args):
    """MovieLens ratings (the repo's largest REAL dataset: ~100k rows; the
    reference ships examples/data/movielens.csv but never wires it into any
    driver) -> binary "will this user like this movie" logistic-regression
    task + REAL per-user groups for the group-selection / data-valuation
    experiment.

    Features are leakage-free collaborative statistics: leave-one-out user
    mean rating, leave-one-out movie mean rating (train-split only; test
    rows use plain train means), log activity counts, and normalized
    timestamp; label y = +1 iff rating >= 4. Groups: the --n-groups most
    active users, each group = that user's train rows (capped at --cap),
    written as a vq_groups_sensemake-style pickle (reference
    preproc_adult.py:20-48 artifact format) over the grouped-row subset."""
    import pandas as pd

    df = pd.read_csv(args.raw[0])
    rng = np.random.default_rng(42)
    n = len(df)
    is_test = np.zeros(n, dtype=bool)
    is_test[rng.permutation(n)[: int(0.1 * n)]] = True
    r = df["rating"].to_numpy(float)
    y = np.where(r >= 4.0, 1.0, -1.0)
    uid = df["userId"].to_numpy()
    mid = df["movieId"].to_numpy()

    tr = df.loc[~is_test]
    gmean = float(tr["rating"].mean())
    us = tr.groupby("userId")["rating"].agg(["sum", "count"])
    ms = tr.groupby("movieId")["rating"].agg(["sum", "count"])
    u_sum = us["sum"].reindex(uid).fillna(0.0).to_numpy()
    u_cnt = us["count"].reindex(uid).fillna(0).to_numpy(float)
    m_sum = ms["sum"].reindex(mid).fillna(0.0).to_numpy()
    m_cnt = ms["count"].reindex(mid).fillna(0).to_numpy(float)
    own = (~is_test).astype(float)  # train rows contribute to their own stats
    u_loo = np.where(u_cnt - own > 0, (u_sum - r * own) / np.maximum(u_cnt - own, 1.0), gmean)
    m_loo = np.where(m_cnt - own > 0, (m_sum - r * own) / np.maximum(m_cnt - own, 1.0), gmean)
    ts = df["timestamp"].to_numpy(float)
    feats = np.c_[u_loo - gmean, m_loo - gmean,
                  np.log1p(u_cnt), np.log1p(m_cnt),
                  (ts - ts[~is_test].mean()) / (ts[~is_test].std() + 1e-12)]
    feats = (feats - feats[~is_test].mean(0)) / (feats[~is_test].std(0) + 1e-12)
    X = add_intercept(feats)
    np.savez(os.path.join(args.out_dir, "movielens.npz"),
             X=X[~is_test], y=y[~is_test], Xt=X[is_test], yt=y[is_test])
    print(f"movielens: N={int((~is_test).sum())} d={X.shape[1]} "
          f"test={int(is_test.sum())} pos-rate={float((y[~is_test] > 0).mean()):.3f}")

    # --- native 5-class star-rating task (models/multiclass.py) ---------
    # the binary task collapses the rating scale; the multiclass family
    # predicts the star bucket directly: class = ceil(rating) - 1 in {0..4}
    # (half-stars round up), same leakage-free features
    y5 = np.clip(np.ceil(r), 1, 5) - 1.0
    np.savez(os.path.join(args.out_dir, "movielens5.npz"),
             X=X[~is_test], y=y5[~is_test], Xt=X[is_test], yt=y5[is_test])
    base5 = np.bincount(y5[~is_test].astype(int), minlength=5).max() / (~is_test).sum()
    print(f"movielens5: 5-class star buckets, base rate {base5:.3f}")

    # --- per-user groups over the most active users ---------------------
    n_groups = getattr(args, "n_groups", 100)
    top_users = us["count"].sort_values(ascending=False).index[:n_groups]
    train_rows = np.where(~is_test)[0]
    uid_train = uid[train_rows]
    grouped_rows, groups, demos = [], [], []
    cnt_max = float(us["count"].max())
    for u in top_users:
        rows = np.where(uid_train == u)[0][: args.cap]  # train-local indices
        if len(rows) == 0:
            continue
        start = len(grouped_rows)
        grouped_rows.extend(rows.tolist())
        groups.append(list(range(start, start + len(rows))))
        n_u = float(us.loc[u, "count"])
        # corruption propensity: casual (low-activity) users are noisier —
        # the driver corrupts each group proportional to demos[g][0]
        # (reference group_selection.py:129-131 semantics)
        demos.append((1.0 - n_u / cnt_max, int(u), int(n_u), float(us.loc[u, "sum"] / n_u)))
    sel = np.asarray(grouped_rows)
    np.savez(os.path.join(args.out_dir, "movielens_grouped.npz"),
             X=X[~is_test][sel], y=y[~is_test][sel], Xt=X[is_test], yt=y[is_test])
    with open(os.path.join(args.out_dir, "vq_groups_sensemake_movielens_grouped.pk"), "wb") as f:
        pickle.dump((groups, demos), f)
    print(f"movielens_grouped: {len(groups)} real user-groups over {len(sel)} rows")


def postcode_to_int(code: str) -> int:
    """Reference's digit-concatenation postcode tag
    (process_housing_prices.py:17): per character, letters map to
    ord-97 >= 0 else digits map to ord-48, concatenated as a decimal string."""
    out = []
    for a in code.replace(" ", ""):
        v = ord(a.lower()) - 97
        out.append(str(v) if v >= 0 else str(ord(a.lower()) - 48))
    return int("".join(out))


def cmd_housing(args):
    """UK price-paid x GB postcode geocoding join -> (lat, lon, price) rows
    (reference process_housing_prices.py; its O(N) python merge loop becomes
    a vectorized sorted searchsorted join). --raw <pp-YYYY.csv> <GB_FULL.txt>."""
    pp_path, geo_path = args.raw[0], args.raw[1]
    # GB_FULL.txt: tab-separated, postal_code is column 1, lat/lon cols 9/10
    geo_codes, geo_lat, geo_lon = [], [], []
    with open(geo_path) as fh:
        next(fh)  # header
        for line in fh:
            t = line.rstrip("\n").split("\t")
            try:
                geo_codes.append(postcode_to_int(t[1]))
                geo_lat.append(float(t[9]))
                geo_lon.append(float(t[10]))
            except (ValueError, IndexError):
                continue
    geo_codes = np.asarray(geo_codes, dtype=np.int64)
    order = np.argsort(geo_codes)
    geo_codes = geo_codes[order]
    geo_ll = np.c_[np.asarray(geo_lat), np.asarray(geo_lon)][order]

    codes, prices = [], []
    with open(pp_path) as fh:
        for line in fh:
            t = [s.strip(' "') for s in line.split(",")]
            try:
                codes.append(postcode_to_int(t[3]))
                prices.append(float(t[1]))
            except (ValueError, IndexError):
                continue
    codes = np.asarray(codes, dtype=np.int64)
    prices = np.asarray(prices)
    pos = np.searchsorted(geo_codes, codes)
    pos = np.clip(pos, 0, len(geo_codes) - 1)
    hit = geo_codes[pos] == codes
    out = np.c_[geo_ll[pos[hit]], prices[hit]]
    np.save(os.path.join(args.out_dir, "prices2018.npy"), out)
    print(f"housing: {out.shape[0]}/{len(codes)} entries geocoded")


def parser():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ["adult", "diabetes", "phishing", "webspam", "covtype", "mnist2",
                 "housing", "movielens"]:
        p = sub.add_parser(name)
        p.add_argument("--raw", nargs="+", required=True)
        p.add_argument("--out-dir", default="data")
        p.add_argument("--cap", type=int, default=100)
        p.add_argument("--subsample", type=int, default=0)
        p.add_argument("--pca", type=int, default=0)
        if name == "mnist2":
            p.add_argument("--a", type=int, default=3)
            p.add_argument("--b", type=int, default=8)
        if name == "movielens":
            p.add_argument("--n-groups", type=int, default=100)
        # the port's flags: preprocessing runs on the host and draws from
        # the JAX script's fixed numpy seeds
        p.add_argument("--device", default="cuda", help="unused: preprocessing runs on the host")
        p.add_argument("--seed", type=int, default=0,
                       help="unused: the splits use the JAX script's fixed seeds")
    return ap


def main(argv=None):
    """Runs one subcommand; returns its parsed arguments."""
    args = parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for f in args.raw:
        if not os.path.exists(f):
            sys.exit(f"raw file not found: {f} (no network egress; provide local files)")
    globals()[f"cmd_{args.cmd}"](args)
    return args


if __name__ == "__main__":
    main()
