"""Measure the port's native C++ loader against numpy text parsing
(counterpart of examples/bench_native_loader.py).

Generates webspam-shaped synthetic files (the reference's largest published
config: d=127 features + label, N=126,185) as CSV and svmlight in
``--workdir``, parses each with native/loader.cpp (built with g++ into
build/native/ by data/native_loader.py) and with the numpy/pure-Python
fallbacks, cross-checks values, and reports MB/s + speedups. A
--scale-rows GB-class CSV is additionally parsed native-only (the numpy
baseline at that size is minutes-class; its rate is size-independent, so
the small-file rate is the honest baseline). Every parse rate is a host
rate, of the machine's CPU. The port adds the upload of the parsed CSV
onto ``--device`` (a copy into a new tensor there, timed around
``torch.cuda.synchronize()`` on a card), the step a loader takes after the
parse. ``--seed`` offsets the files' numpy seeds; 0 (the default) writes
the JAX script's files, byte for byte.

Run: python -m betacores_tpu_torch.examples.bench_native_loader [--rows 126185] [--scale-rows 1000000] [--device cuda]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from betacores_tpu_torch.data import native_loader as nl
from betacores_tpu_torch.examples._common import add_port_flags, device_line, seed_of, sync


def gen_csv(path, rows, cols, seed=0, block=100_000):
    """The JAX script's file, byte for byte (the same draws, row after row,
    in "%.6f"), written a block of rows at a time."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(0, rows, block):
            np.savetxt(f, rng.standard_normal((min(block, rows - i), cols)), fmt="%.6f",
                       delimiter=",")
    return os.path.getsize(path)


def gen_svmlight(path, rows, n_features, nnz_per_row, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            y = rng.choice([-1, 1])
            idx = np.sort(rng.choice(n_features, nnz_per_row, replace=False)) + 1
            vals = rng.standard_normal(nnz_per_row)
            f.write(f"{y} " + " ".join(
                f"{i}:{v:.6f}" for i, v in zip(idx, vals)) + "\n")
    return os.path.getsize(path)


def timed(fn, reps=2):
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=126_185)
    ap.add_argument("--cols", type=int, default=128,
                    help="webspam: 127 features + label")
    ap.add_argument("--scale-rows", type=int, default=1_000_000,
                    help="rows for the GB-class native-only CSV parse "
                         "(0 = skip)")
    ap.add_argument("--nnz", type=int, default=32,
                    help="nonzeros per svmlight row")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "bcloader_bench"))
    add_port_flags(ap)
    return ap


def _file(args, workdir_name):
    """A file of ``--workdir``; a non-zero ``--seed`` names its own."""
    stem, ext = os.path.splitext(workdir_name)
    return os.path.join(args.workdir, f"{stem}_s{args.seed}{ext}" if args.seed else workdir_name)


def _upload(X, device):
    """The parsed rows as a new tensor on ``device``, once it holds them."""
    out = torch.tensor(X, device=device)
    sync(device)
    return out


def main(argv=None):
    """Prints the JSON record; returns it (None without a C++ compiler)."""
    args = parser().parse_args(argv)

    if not nl.native_available():
        print(json.dumps({"error": "native loader unavailable (no toolchain)"}))
        return None
    os.makedirs(args.workdir, exist_ok=True)
    rec = {"host_cores": os.cpu_count()}
    print(f"host rates, on this machine's CPU ({os.cpu_count()} cores)", file=sys.stderr)

    # --- CSV, webspam shape ---
    csv_path = _file(args, "webspam_shape.csv")
    if not os.path.exists(csv_path):
        gen_csv(csv_path, args.rows, args.cols, seed=seed_of(args, 0))
    sz = os.path.getsize(csv_path)
    t_nat, X_nat = timed(lambda: nl.load_csv(csv_path))
    t_np, X_np = timed(
        lambda: np.atleast_2d(np.genfromtxt(csv_path, delimiter=",")
                              .astype(np.float32)), reps=1)
    t_lt, X_lt = timed(
        lambda: np.loadtxt(csv_path, delimiter=",").astype(np.float32), reps=1)
    assert X_nat.shape == X_np.shape == (args.rows, args.cols)
    err = float(np.max(np.abs(X_nat - X_np)))
    rel = err / float(np.max(np.abs(X_np)))
    assert rel < 1e-6, f"native CSV values diverge from numpy: rel={rel}"
    rec["csv"] = {
        "rows": args.rows, "cols": args.cols, "mb": round(sz / 1e6, 1),
        "native_s": round(t_nat, 3), "native_mb_s": round(sz / 1e6 / t_nat, 1),
        "genfromtxt_s": round(t_np, 2), "loadtxt_s": round(t_lt, 2),
        "speedup_vs_genfromtxt": round(t_np / t_nat, 1),
        "speedup_vs_loadtxt": round(t_lt / t_nat, 1),
        "max_rel_err_vs_numpy": rel,
    }
    print(f"CSV {sz/1e6:.0f} MB: native {t_nat:.2f}s "
          f"({sz/1e6/t_nat:.0f} MB/s), genfromtxt {t_np:.1f}s, "
          f"loadtxt {t_lt:.1f}s -> {t_np/t_nat:.1f}x / {t_lt/t_nat:.1f}x",
          file=sys.stderr)

    # --- the parsed CSV onto --device (the port's step after the parse) ---
    t_up, X_dev = timed(lambda: _upload(X_nat, args.device))
    assert tuple(X_dev.shape) == X_nat.shape
    mb = X_nat.nbytes / 1e6
    rec["upload"] = {"device": device_line(args.device), "mb": round(mb, 1),
                     "s": round(t_up, 4), "mb_s": round(mb / max(t_up, 1e-9), 1)}
    print(f"upload {mb:.0f} MB of float32 rows onto {args.device} "
          f"({rec['upload']['device']}): {t_up*1e3:.1f} ms "
          f"({rec['upload']['mb_s']:.0f} MB/s)", file=sys.stderr)
    del X_dev

    # --- svmlight, webspam shape (webspam ships as svmlight) ---
    svm_path = _file(args, "webspam_shape.svm")
    if not os.path.exists(svm_path):
        gen_svmlight(svm_path, args.rows, args.cols - 1, args.nnz, seed=seed_of(args, 0))
    ssz = os.path.getsize(svm_path)
    t_snat, (Xs, ys) = timed(lambda: nl.load_svmlight(svm_path, args.cols - 1))
    t_spy, (Xp, yp) = timed(
        lambda: nl._svmlight_numpy(svm_path, args.cols - 1), reps=1)
    assert Xs.shape == Xp.shape
    srel = float(np.max(np.abs(Xs - Xp))) / max(float(np.max(np.abs(Xp))), 1e-9)
    assert srel < 1e-6 and np.array_equal(ys, yp)
    rec["svmlight"] = {
        "rows": args.rows, "mb": round(ssz / 1e6, 1),
        "native_s": round(t_snat, 3),
        "native_mb_s": round(ssz / 1e6 / t_snat, 1),
        "python_s": round(t_spy, 2),
        "speedup_vs_python": round(t_spy / t_snat, 1),
        "max_rel_err": srel,
    }
    print(f"svmlight {ssz/1e6:.0f} MB: native {t_snat:.2f}s "
          f"({ssz/1e6/t_snat:.0f} MB/s), pure-python {t_spy:.1f}s "
          f"-> {t_spy/t_snat:.1f}x", file=sys.stderr)

    # --- GB-class CSV, native only ---
    if args.scale_rows:
        big_path = _file(args, "scale.csv")
        if not os.path.exists(big_path):
            print(f"generating {args.scale_rows}-row CSV...", file=sys.stderr)
            gen_csv(big_path, args.scale_rows, args.cols, seed=seed_of(args, 1))
        bsz = os.path.getsize(big_path)
        t_big, Xb = timed(lambda: nl.load_csv(big_path), reps=1)
        assert Xb.shape == (args.scale_rows, args.cols)
        rec["csv_scale"] = {"rows": args.scale_rows,
                           "gb": round(bsz / 1e9, 2),
                           "native_s": round(t_big, 2),
                           "native_mb_s": round(bsz / 1e6 / t_big, 1)}
        print(f"CSV {bsz/1e9:.2f} GB: native {t_big:.1f}s "
              f"({bsz/1e6/t_big:.0f} MB/s)", file=sys.stderr)

    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
