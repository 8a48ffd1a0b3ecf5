"""Differentially-private pseudo-coreset: privacy/utility tradeoff, through
the port (counterpart of examples/dp_bpsvi.py).

Sweeps the Gaussian-mechanism noise multiplier of
``DiffPrivBatchPSVICoreset`` and reports, per privacy level, the RDP
(eps, delta)-bound of the released coreset and its reverse KL against the
exact (non-private) full-data conjugate posterior, next to the non-private
BPSVI build and the prior. The rows are the JAX driver's: numpy's
``default_rng(--trial)``.

Usage: python -m betacores_tpu_torch.examples.dp_bpsvi [--noise-grid 0.5,1,2,4] [--M 30] ...
"""

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.evaluation import reverse_forward_kl
from betacores_tpu_torch.examples._common import (add_port_flags, device_line, host, seed_of,
                                                   sync)
from betacores_tpu_torch.inference import gaussian_conjugate_sampler
from betacores_tpu_torch.models import gaussian as gmod


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--N", type=int, default=5000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--M", type=int, default=30, help="pseudo-points")
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=300)
    ap.add_argument("--n-subsample-opt", type=int, default=500)
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--delta", type=float, default=1e-5)
    ap.add_argument("--noise-grid", default="0.5,1.0,2.0,4.0")
    ap.add_argument("--sampling", choices=("poisson", "swr"), default="poisson",
                    help="poisson: subsampled-Gaussian RDP accounting "
                         "(amplification by subsampling); swr: round-3 "
                         "unamplified substitution accounting")
    ap.add_argument("--results-dir", default="results")
    add_port_flags(ap)
    return ap


def main(argv=None):
    """Returns the record the JSON line prints: ``rows`` and ``rkl_prior``."""
    args = parser().parse_args(argv)
    dev = args.device
    d, S = args.d, args.proj_dim
    rng = np.random.default_rng(args.trial)
    X_np = (rng.standard_normal((args.N, d)) + 1.0).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)

    f32 = dict(dtype=torch.float32, device=dev)
    Siginv, logdetSig = torch.eye(d, **f32), 0.0
    mu0, Sig0inv = torch.zeros(d, **f32), torch.eye(d, **f32)
    model = gmod.bundle(Siginv, logdetSig)
    sampler = gaussian_conjugate_sampler(mu0, Sig0inv, Siginv)
    post_full = gmod.weighted_post(mu0, Sig0inv, Siginv, X, torch.ones(args.N, **f32))

    def rkl_of(w, p):
        p = torch.from_numpy(np.atleast_2d(np.asarray(p, dtype=np.float32))).to(dev)
        w = torch.from_numpy(np.atleast_1d(np.asarray(w, dtype=np.float32))).to(dev)
        post = gmod.weighted_post(mu0, Sig0inv, Siginv, p, w)
        return float(reverse_forward_kl(post, post_full)[0])

    sched = lambda m: (lambda i: args.i0 / (1.0 + i))
    prj = bc.BlackBoxProjector(sampler, S, model=model)
    seed = seed_of(args, args.trial)

    rows = []
    # non-private reference point (same BPSVI objective, no clip/noise)
    alg0 = bc.BatchPSVICoreset(X, prj, opt_itrs=args.opt_itrs,
                               n_subsample_opt=args.n_subsample_opt, step_sched=sched,
                               seed=seed, max_size=args.M, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    alg0.build(1, args.M)
    w, p = alg0.get()[:2]
    sync(dev)
    rows.append({"eps": float("inf"), "noise": 0.0, "rkl": rkl_of(w, p),
                 "nnz": int((host(w) > 0).sum()),
                 "t_s": round(time.perf_counter() - t0, 2)})

    for nm in (float(s) for s in args.noise_grid.split(",")):
        alg = bc.DiffPrivBatchPSVICoreset(
            X, prj, opt_itrs=args.opt_itrs, n_subsample_opt=args.n_subsample_opt,
            step_sched=sched, clip_norm=args.clip_norm, noise_multiplier=nm,
            delta=args.delta, seed=seed, sampling=args.sampling, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        alg.build(1, args.M)
        w, p = alg.get()
        sync(dev)
        rows.append({"eps": round(alg.epsilon(), 3), "noise": nm,
                     "rkl": rkl_of(w, p), "nnz": int(len(w)),
                     "t_s": round(time.perf_counter() - t0, 2)})

    prior = gmod.GaussianPosterior(mu=mu0, prec_chol=torch.eye(d, **f32))
    rkl_prior = float(reverse_forward_kl(prior, post_full)[0])
    print(f"N={args.N} d={d} M={args.M} delta={args.delta} "
          f"(prior rKL={rkl_prior:.4g})")
    print(f"{'noise':>6} {'eps':>10} {'rKL':>12} {'nnz':>4} {'t[s]':>6}")
    for r in rows:
        print(f"{r['noise']:>6g} {r['eps']:>10g} {r['rkl']:>12.4g} "
              f"{r['nnz']:>4d} {r['t_s']:>6.1f}")
    print(f"times on {device_line(dev)}")
    os.makedirs(args.results_dir, exist_ok=True)
    out = os.path.join(
        args.results_dir,
        f"results_dpbpsvi_N{args.N}_M{args.M}_{args.sampling}_{args.trial}.pk")
    with open(out, "wb") as f:
        pickle.dump({"rows": rows, "rkl_prior": rkl_prior, "config": vars(args)}, f)
    rec = {"rows": rows, "rkl_prior": rkl_prior}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
