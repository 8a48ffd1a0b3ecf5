"""Does a build follow from its seed? Hashes the headline data and a short
headline build in separate processes and compares the digests.

    python3 tools/seed_repro.py [--seed 0] [--n 1000000] [--selections 5]

Each case runs twice, each run in a process of its own:

  data            bench_torch.make_data's rows Z
  data-indexed    the same draws with the feature noise written through one
                  indexed assignment over the repeated row indices (what
                  perturb_logreg did before it kept the last draw): on a card
                  the winner among repeated rows is the scheduler's
  build-captured  ``selections`` headline selections, passes replayed as
                  CUDA graphs (digest of idcs and weights)
  build-eager     the same with graph=False

The last line is one JSON object: for each case its digests and whether
they agree, and whether the captured and eager builds agree with each
other. Exit code 1 when ``data`` or a build differs between its two runs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import torch

CASES = ("data", "data-indexed", "build-captured", "build-eager")


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def indexed_data(n: int, dev: torch.device, seed: int) -> torch.Tensor:
    """bench_torch.make_data's draws, with the feature noise written by one
    indexed assignment over the repeated row indices."""
    import bench_torch
    from betacores_tpu_torch import gen_synthetic_logreg

    gen = torch.Generator(device=dev).manual_seed(seed)
    X, y, _ = gen_synthetic_logreg(gen, n, d=bench_torch.D_FEAT)
    D, o = X.shape[1], int(n * bench_torch.F_RATE)
    idxx = torch.randint(0, n, (o,), generator=gen, device=dev)
    idxy = torch.randint(0, n, (o,), generator=gen, device=dev)
    cols = torch.randperm(D, generator=gen, device=dev)[:D // 2]
    noise = 5.0 * torch.randn((o, D // 2), generator=gen, dtype=X.dtype, device=dev)
    X = X.clone()
    X[idxx[:, None], cols[None, :]] = noise
    y = y.clone()
    y[idxy] = -y[idxy]
    return y[:, None] * X


def one(case: str, seed: int, n: int, selections: int, device: str) -> str:
    import bench_torch
    from betacores_tpu_torch import (IncrementalConfig, init_state, logreg,
                                     logreg_laplace_sampler, make_incremental_builder)

    dev = torch.device(device)
    if case == "data-indexed":
        return digest(indexed_data(n, dev, seed))
    gen, Z = bench_torch.make_data(n, dev, seed)
    if case == "data":
        return digest(Z)
    cfg = IncrementalConfig(projection_dim=bench_torch.S,
                            n_subsample_select=bench_torch.N_SUB_SEL,
                            n_subsample_opt=bench_torch.N_SUB_OPT,
                            opt_itrs=bench_torch.OPT_ITRS, i0=bench_torch.I0, use_beta=True)
    builder = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg,
                                       graph=None if case == "build-captured" else False)
    st0 = init_state(bench_torch.M_BUF, bench_torch.D_FEAT, beta=bench_torch.BETA, device=dev)
    st = builder.build(st0, selections, builder.generator_draws(gen))
    return digest(st.idcs, st.wts, st.m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--selections", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--case", choices=CASES, help="run one case here and print its digest")
    args = ap.parse_args(argv)
    if args.case:
        print(one(args.case, args.seed, args.n, args.selections, args.device))
        return 0
    out = {}
    for case in CASES:
        cmd = [sys.executable, __file__, "--case", case, "--seed", str(args.seed),
               "--n", str(args.n), "--selections", str(args.selections),
               "--device", args.device]
        runs = [subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=900)
                .stdout.split()[-1] for _ in range(2)]
        out[case] = {"digests": runs, "agree": runs[0] == runs[1]}
        print(f"{case}: {runs}", file=sys.stderr, flush=True)
    out["captured_equals_eager"] = (out["build-captured"]["digests"][0]
                                    == out["build-eager"]["digests"][0])
    print(json.dumps(out))
    ok = all(out[c]["agree"] for c in ("data", "build-captured", "build-eager"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
