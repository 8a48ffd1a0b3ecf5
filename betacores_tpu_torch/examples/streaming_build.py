"""Out-of-core streaming coreset build (merge-reduce) on contaminated
logistic regression, through the port (counterpart of
examples/streaming_build.py).

Generates N contaminated rows chunk by chunk on the device and keeps them
on the HOST (the device only ever holds one chunk + the leaf coresets),
builds an m_leaf beta-coreset per chunk through one builder, then
summarizes the weighted leaf union with a final m_final build. Reports
wall-clock per phase and held-out predictive quality of the streamed
coreset vs a single-shot build on the same data (when the data fits) and
vs the prior.

Usage:
  python -m betacores_tpu_torch.examples.streaming_build --N 4000000 --chunk-size 1000000
  python -m betacores_tpu_torch.examples.streaming_build --N 200000 --chunk-size 50000 \
      --compare-single-shot
"""

import argparse
import sys
import time

import numpy as np
import torch

from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                          make_incremental_builder, merge_reduce_build)
from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
from betacores_tpu_torch.evaluation import compute_accuracy
from betacores_tpu_torch.examples._common import (add_port_flags, device_line, keyed,
                                                   seed_of, sync)
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from betacores_tpu_torch.utils import Timings


def host_chunks(args, N, d, chunk, f_rate):
    """Contaminated synthetic logreg, made chunk by chunk on the device and
    copied to HOST memory (the out-of-core pattern: the full dataset never
    exists on the device; each chunk's device buffer is freed before the
    next). Chunk i draws from its own generator."""
    out = []
    n_done = 0
    i = 0
    while n_done < N:
        n_i = min(chunk, N - n_done)
        g = keyed(args, 100_000 + i)
        X, y, _ = gen_synthetic_logreg(g, n_i, d=d, dtype=torch.float32)
        out.append(perturb_logreg(g, X, y, f_rate=f_rate)[2].cpu().numpy())
        n_done += n_i
        i += 1
    return out


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--chunk-size", type=int, default=50_000)
    ap.add_argument("--f-rate", type=float, default=0.1)
    ap.add_argument("--m-leaf", type=int, default=50)
    ap.add_argument("--m-final", type=int, default=100)
    ap.add_argument("--m-buf", type=int, default=64)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=300)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--parallel-leaves", action="store_true")
    ap.add_argument("--compare-single-shot", action="store_true")
    add_port_flags(ap)
    return ap


def main(argv=None):
    """Returns the build: ``state`` (the final coreset), ``leaf_pts`` and
    ``leaf_wts`` (the union it summarised), ``timings`` (a ``Timings`` of
    each leaf and the final build), ``acc``, ``acc_prior``, ``t_stream``,
    ``rows`` (the host data), and with ``--compare-single-shot``
    ``acc_single``."""
    args = parser().parse_args(argv)
    dev = args.device
    t0 = time.perf_counter()
    chunks = host_chunks(args, args.N, args.d, args.chunk_size, args.f_rate)
    data_host = np.concatenate(chunks)
    # clean held-out test set
    Xt, Yt, _ = gen_synthetic_logreg(keyed(args, 999), 20_000, d=args.d, dtype=torch.float32)
    print(f"host data: N={data_host.shape[0]} d={args.d} "
          f"({data_host.nbytes / 1e9:.2f} GB, {len(chunks)} chunks) "
          f"in {time.perf_counter() - t0:.1f}s on {device_line(dev)}", file=sys.stderr)

    model = logreg.bundle()
    sampler = logreg_laplace_sampler()
    leaf_cfg = IncrementalConfig(
        projection_dim=args.proj_dim,
        n_subsample_select=min(1000, args.chunk_size),
        n_subsample_opt=min(200, args.chunk_size),
        opt_itrs=args.opt_itrs, i0=1.0, use_beta=True)
    final_cfg = IncrementalConfig(
        projection_dim=args.proj_dim, n_subsample_select=None,
        n_subsample_opt=None, opt_itrs=max(args.opt_itrs, 500), i0=1.0,
        use_beta=True)
    st_leaf = init_state(args.m_buf, args.d, beta=args.beta, dtype=torch.float32, device=dev)

    tm = Timings()
    sync(dev)
    t0 = time.perf_counter()
    st_f, leaf_pts, leaf_wts = merge_reduce_build(
        seed_of(args, 1), data_host, model, sampler, leaf_cfg, final_cfg,
        args.chunk_size, args.m_leaf, args.m_final, st_leaf,
        parallel_leaves=args.parallel_leaves, device=dev, timings=tm)
    sync(dev)
    t_stream = time.perf_counter() - t0
    n_sel = int(st_f.m)
    card = device_line(dev)
    print(f"merge-reduce: {len(chunks)} leaves x m={args.m_leaf} -> "
          f"final m={n_sel} in {t_stream:.2f}s "
          f"({'batched' if args.parallel_leaves else 'streamed'}) on {card}",
          file=sys.stderr)

    def acc_of(wts, pts):
        wts = torch.as_tensor(np.asarray(wts, dtype=np.float32), device=dev)
        pts = torch.as_tensor(np.asarray(pts, dtype=np.float32), device=dev)
        lap = sampler(keyed(args, 2), args.proj_dim, wts, pts,
                      torch.zeros(args.d, device=dev))[0]
        return float(compute_accuracy(Xt, Yt, lap))

    mask = st_f.slot_mask.cpu().numpy()
    acc_stream = acc_of(st_f.wts.cpu().numpy()[mask], st_f.pts.cpu().numpy()[mask])
    acc_prior = acc_of(np.zeros(1), np.zeros((1, args.d)))
    line = (f"streamed coreset m={n_sel}: test acc {acc_stream:.4f} "
            f"(prior {acc_prior:.4f}) build {t_stream:.2f}s")
    out = {"state": st_f, "leaf_pts": leaf_pts, "leaf_wts": leaf_wts, "timings": tm,
           "acc": acc_stream, "acc_prior": acc_prior, "t_stream": t_stream, "rows": data_host}

    if args.compare_single_shot:
        sync(dev)
        t0 = time.perf_counter()
        b = make_incremental_builder(torch.from_numpy(data_host).to(dev), model, sampler,
                                     leaf_cfg)
        st_s = b.build(init_state(args.m_buf * 2, args.d, beta=args.beta,
                                  dtype=torch.float32, device=dev),
                       args.m_final, b.generator_draws(keyed(args, 2)))
        sync(dev)
        t_single = time.perf_counter() - t0
        sm = st_s.slot_mask.cpu().numpy()
        acc_single = acc_of(st_s.wts.cpu().numpy()[sm], st_s.pts.cpu().numpy()[sm])
        line += (f"; single-shot m={int(st_s.m)} acc {acc_single:.4f} "
                 f"build {t_single:.2f}s")
        out["acc_single"] = acc_single
    print(line + f" [{card}]")
    return out


if __name__ == "__main__":
    main()
