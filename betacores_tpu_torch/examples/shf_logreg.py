"""Sparse Hamiltonian Flow against HMC on Bayesian logistic regression,
through the port (counterpart of examples/shf_logreg.py).

Trains a coreset-parameterized normalizing flow against the full-data ELBO,
then compares its i.i.d. posterior samples with multi-chain HMC on the same
data: predictive accuracy, test log-likelihood and sampling cost. Prints
its results (the JAX driver writes no results file either).

Usage: python -m betacores_tpu_torch.examples.shf_logreg --N 20000 --train-steps 6000
"""

import argparse
import time

import numpy as np
import torch

from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
from betacores_tpu_torch.evaluation import compute_accuracy, predictive_loglik
from betacores_tpu_torch.examples._common import add_port_flags, host, keyed, sync
from betacores_tpu_torch.inference import (HMCConfig, SHFConfig, init_shf_params,
                                           make_shf_trainer, shf_sample, summarize_chains)
from betacores_tpu_torch.models import logreg


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=20000)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--trial", type=int, default=1)
    ap.add_argument("--f-rate", type=float, default=0.0, help="corruption rate")
    ap.add_argument("--beta", type=float, default=None,
                    help="train against the robust beta-divergence objective "
                         "(beta_log_joint) instead of the standard ELBO")
    ap.add_argument("--M", type=int, default=30, help="flow coreset size")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--leapfrog", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=2000,
                    help="train in chunks of this many steps")
    ap.add_argument("--n-samples", type=int, default=2000)
    add_port_flags(ap)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = args.device
    gen = keyed(args, args.trial)
    X, Y, Z = gen_synthetic_logreg(gen, args.N, d=args.d)
    if args.f_rate > 0:
        X, Y, Z, _ = perturb_logreg(keyed(args, args.trial + 5_000), X, Y, f_rate=args.f_rate)
    Xt, Yt, Zt = gen_synthetic_logreg(gen, 2000, d=args.d)
    print(f"N={args.N} d={args.d} f_rate={args.f_rate}")

    # --- the flow: train, then i.i.d. samples ---
    if args.beta is not None:
        from betacores_tpu_torch.inference import beta_log_joint

        target = beta_log_joint(logreg.bundle(), args.beta)
        print(f"robust beta-divergence objective, beta={args.beta}")
    else:
        target = logreg.log_joint
    cfg = SHFConfig(n_blocks=args.blocks, n_leapfrog=args.leapfrog, n_mc=8, n_batch=256,
                    learning_rate=1e-2)
    params = init_shf_params(Z[: args.M], args.d, args.N, cfg)
    train = make_shf_trainer(Z, target, cfg)
    t0 = time.perf_counter()
    n_chunks, rem = divmod(args.train_steps, args.chunk)
    for i in range(n_chunks):
        params, trace = train(keyed(args, 100 + i), params, args.chunk)
    if rem:
        params, trace = train(keyed(args, 100 + n_chunks), params, rem)
    sync(dev)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    th_f, _, logq = shf_sample(keyed(args, 7), params, target, args.n_samples, cfg)
    sync(dev)
    t_flow_sample = time.perf_counter() - t0
    acc_f = float(compute_accuracy(Xt, Yt, th_f))
    pll_f = float(predictive_loglik(Zt, th_f))
    print(f"SHF : train {t_train:.1f}s ({args.train_steps} steps), "
          f"{args.n_samples} iid samples in {t_flow_sample:.2f}s; "
          f"acc={acc_f:.4f} pll={pll_f:.4f} "
          f"coreset nnz={int((host(params.w) > 0).sum())} "
          f"elbo_tail={float(host(trace)[-20:].mean()):.1f}")

    # --- the HMC baseline on the full data (2 diagnosed chains) ---
    from betacores_tpu_torch.inference import run_chains_weighted_logreg

    t0 = time.perf_counter()
    chains, stats = run_chains_weighted_logreg(
        keyed(args, args.trial * 7), Z, torch.ones(args.N, device=dev),
        torch.zeros(args.d, device=dev), 2,
        HMCConfig(n_samples=args.n_samples // 2, n_warmup=1000, L_max=32))
    sync(dev)
    t_hmc = time.perf_counter() - t0
    th_h = chains.reshape(-1, args.d)
    summ = summarize_chains(chains)
    acc_h = float(compute_accuracy(Xt, Yt, th_h))
    pll_h = float(predictive_loglik(Zt, th_h))
    print(f"HMC : {th_h.shape[0]} samples in {t_hmc:.1f}s (warmup incl.); "
          f"acc={acc_h:.4f} pll={pll_h:.4f} "
          f"rhat={float(np.asarray(host(summ['rhat'])).max()):.3f} "
          f"ess={float(np.asarray(host(summ['ess'])).min()):.0f}")
    gap = float(torch.linalg.norm(th_f.mean(0) - th_h.mean(0)))
    print(f"flow-vs-HMC posterior mean gap: {gap:.4f}")
    return {"acc_flow": acc_f, "pll_flow": pll_f, "acc_hmc": acc_h, "pll_hmc": pll_h,
            "gap": gap, "train_s": t_train, "hmc_s": t_hmc}


if __name__ == "__main__":
    main()
