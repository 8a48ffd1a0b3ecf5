"""Tabulate the available logreg/count datasets, through the port
(counterpart of examples/data_tabulate.py): the table is computed from the
npz files found in ``--dirs`` with the port's ``data.loaders.load_npz``.
The default directories are the port's data roots (``$BETACORES_DATA``,
then the repository's ``data/``) and ``data`` under the working directory.

Usage: python -m betacores_tpu_torch.examples.data_tabulate [--dirs data] [--latex]
"""

import argparse
import glob
import os
import sys

import numpy as np

from betacores_tpu_torch.data.loaders import _data_roots, load_npz

SEARCH_DIRS = [r for r in _data_roots() if r] + ["data"]


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--latex", action="store_true")
    ap.add_argument("--dirs", nargs="*", default=SEARCH_DIRS)
    # the port's flags: the table reads files only, on the host
    ap.add_argument("--device", default="cuda", help="unused: the table runs on the host")
    ap.add_argument("--seed", type=int, default=0, help="unused: the table draws nothing")
    return ap


def main(argv=None):
    """Prints the table; returns its rows."""
    args = parser().parse_args(argv)
    rows = []
    seen = set()
    for d in args.dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.npz"))):
            name = os.path.splitext(os.path.basename(path))[0]
            if name in seen:
                continue
            seen.add(name)
            try:
                X, Y, Xt, Yt = load_npz(path)
            except Exception as e:  # malformed blob in a mirror
                print(f"skip {name}: {e}", file=sys.stderr)
                continue
            pos = int((np.asarray(Yt) > 0).sum()) if len(Yt) else 0
            rows.append([name.upper(), X.shape[1], X.shape[0], len(Yt), pos])

    headers = ["Dataset", "D", "N", "Ntest", "Pos. test data"]
    if args.latex:
        print("\\begin{tabular}{l" + "r" * (len(headers) - 1) + "}")
        print(" & ".join(headers) + " \\\\\\hline")
        for r in rows:
            print(" & ".join(str(c) for c in r) + " \\\\")
        print("\\end{tabular}")
    else:
        widths = [max(len(str(r[i])) for r in rows + [headers]) for i in range(len(headers))]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        print(fmt.format(*headers))
        for r in rows:
            print(fmt.format(*r))
    return rows


if __name__ == "__main__":
    main()
