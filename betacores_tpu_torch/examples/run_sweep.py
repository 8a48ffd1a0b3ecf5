"""Cartesian experiment sweeps through the port (counterpart of
examples/run_sweep.py): each grid point runs a ported driver as
``python -m betacores_tpu_torch.examples.<name>``.

Run everything:      python -m betacores_tpu_torch.examples.run_sweep --exp logreg
One grid point (cluster array jobs): --index K   (uses the linearize map)
List the grid:       --list
Arguments after ``--`` go to every driver (e.g. ``-- --device cpu``).
"""

import argparse
import os
import subprocess
import sys

from betacores_tpu_torch.config import linearize

PACKAGE = "betacores_tpu_torch.examples"
# the checkout's root: a driver's process imports the port from it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GRIDS = {
    "gaussian": {
        "script": "zellner_gaussian.py",
        "grid": {"--alg": ["BCORES", "SVI", "BPSVI", "GIGAO", "GIGAR", "RAND"],
                 "--trial": ["1", "2", "3"]},
    },
    # the full logreg protocol: graddiag in {False, True} x i0 in {0.1, 1,
    # 10} x f_rate in {0, 10, 20}% x trial in {1..3}. Boolean flags use the
    # sweep's convention: None = omit the flag, "" = pass it bare.
    "logreg": {
        "script": "zellner_logreg.py",
        "grid": {"--alg": ["BCORES", "SVI", "BPSVI", "RAND"],
                 "--dataset": ["synth_lr", "phishing", "ds1"],
                 "--graddiag": [None, ""],
                 "--i0": ["0.1", "1.0", "10.0"],
                 "--f-rate": ["0.0", "0.1", "0.2"],
                 "--trial": ["1", "2", "3"]},
    },
    # the figure slice of the protocol (one dataset, default i0/graddiag,
    # full f_rate x trial x alg cross): the pickles behind
    # docs/figures/zellner_logreg_f{0,10,20}_acc.png
    "logreg_bands": {
        "script": "zellner_logreg.py",
        "grid": {"--alg": ["BCORES", "SVI", "BPSVI", "RAND"],
                 "--dataset": ["phishing"],
                 "--f-rate": ["0.0", "0.1", "0.2"],
                 "--trial": ["1", "2", "3"]},
    },
    # the i0 x graddiag sensitivity cross at fixed (dataset, f, trial) —
    # the remaining axes of run.sh exercised AS A SWEEP
    "logreg_i0_graddiag": {
        "script": "zellner_logreg.py",
        "grid": {"--alg": ["BCORES"],
                 "--dataset": ["phishing"],
                 "--graddiag": [None, ""],
                 "--i0": ["0.1", "1.0", "10.0"],
                 "--f-rate": ["0.1"],
                 "--trial": ["1"]},
    },
    # reference zellner_neural_linear/run.sh
    "neural_linear": {
        "script": "zellner_neural_linear.py",
        "grid": {"--alg": ["BCORES", "SVI", "RAND"],
                 "--f-rate": ["0.0", "0.1", "0.3"],
                 "--trial": ["1", "2", "3"]},
    },
    # reference group_selection sweeps
    "groups": {
        "script": "group_selection.py",
        "grid": {"--alg": ["BCORES", "DShapley", "RAND"],
                 "--f-rate": ["0.1"],
                 "--trial": ["0", "1", "2"]},
    },
    # Poisson count-data experiment (datasets from the reference's Stan
    # Poisson program; no reference driver existed)
    "poisson": {
        "script": "poisson_regression.py",
        "grid": {"--alg": ["BCORES", "SVI", "RAND"],
                 "--dataset": ["synth_poiss", "biketrips", "airportdelays"],
                 "--f-rate": ["0.0", "0.1"],
                 "--trial": ["1", "2", "3"]},
    },
    # unknown-covariance (NIW) robustness sweep (family the reference never
    # shipped; examples/mvn_unknown_cov.py)
    "mvn": {
        "script": "mvn_unknown_cov.py",
        "grid": {"--alg": ["BCORES", "SVI", "RAND"],
                 "--f-rate": ["0.0", "0.1"],
                 "--trial": ["1", "2", "3"]},
    },
    # multiclass softmax robustness sweep (beyond reference;
    # examples/multiclass.py — incl. the real 5-class MovieLens task)
    "multiclass": {
        "script": "multiclass.py",
        "grid": {"--alg": ["BCORES", "SVI", "RAND"],
                 "--dataset": ["synthetic", "movielens5"],
                 "--f-rate": ["0.0", "0.1", "0.2"],
                 "--trial": ["1", "2", "3"]},
    },
    # Sparse Hamiltonian Flow vs HMC (beyond reference)
    "shf": {
        "script": "shf_logreg.py",
        "grid": {"--f-rate": ["0.0", "0.1"],
                 "--trial": ["1", "2", "3"]},
    },
    # beta sweep (reference logreg_plot.sh: beta in 0.01..0.9)
    "beta_sweep": {
        "script": "zellner_logreg.py",
        "grid": {"--alg": ["BCORES"],
                 "--beta": ["0.01", "0.05", "0.1", "0.3", "0.5", "0.7", "0.9"],
                 "--f-rate": ["0.1", "0.3"],
                 "--trial": ["1"]},
    },
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", choices=sorted(GRIDS), required=True)
    ap.add_argument("--index", type=int, default=None, help="run only grid point K")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("extra", nargs="*", help="extra args forwarded to the script")
    args = ap.parse_args(argv)

    spec = GRIDS[args.exp]
    configs = linearize(spec["grid"])
    if args.list:
        for i, c in enumerate(configs):
            print(i, c)
        return
    todo = configs if args.index is None else [configs[args.index]]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    for i, cfg in enumerate(todo):
        module = f"{PACKAGE}.{os.path.splitext(spec['script'])[0]}"
        cmd = [sys.executable, "-m", module, "--results-dir", args.results_dir]
        for k, v in cfg.items():
            if v is None:       # boolean flag, off: omit entirely
                continue
            cmd.append(k)
            if v != "":         # boolean flag, on: pass bare
                cmd.append(v)
        cmd += list(args.extra)
        print(f"[{i + 1}/{len(todo)}] {' '.join(cmd)}", flush=True)
        r = subprocess.run(cmd, env=env)
        if r.returncode != 0:
            print(f"FAILED (rc={r.returncode}): {cfg}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    main()
