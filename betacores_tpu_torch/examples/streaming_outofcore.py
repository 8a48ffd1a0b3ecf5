"""Out-of-core merge-reduce coreset build at beyond-device scale, through
the port (counterpart of examples/streaming_outofcore.py).

The dataset lives in host RAM (default N = 500M x d = 10 float32 = 20 GB),
generated chunk by chunk with the exact full-data sufficient statistic.
``merge_reduce_build`` (coresets/streaming.py) streams host chunks through
one leaf builder (peak device memory: one chunk + the leaf coresets), then
summarizes the union of weighted leaf points with one final weighted
build.

Quality evidence: the conjugate-Gaussian posterior over ALL N rows is
closed-form from running sums accumulated during generation, so the
streamed coreset's reverse KL against its EXACT full-data posterior is
computable even though the data never sits on the device. A
same-generator single-shot build at --n-single (default 50M) provides the
quality-parity reference point. The rows are the JAX driver's: numpy's
``default_rng(--seed)``; this driver's ``--seed`` is the JAX driver's own
and seeds the builds' generators too.

``--mesh DxS`` runs the mesh-streamed leaf pass: rounds of D simultaneous
leaf builds, one per rank of a D*S world. With ``--device cpu`` the ranks
are processes on the CPU joined by gloo (where the JAX driver forces a
virtual CPU mesh); on cards an NCCL world, one rank a card, so one card
serves only ``--mesh 1x1`` and any larger mesh raises, naming the count.
The ranks read the host rows from one memory-mapped file.

Usage: python -m betacores_tpu_torch.examples.streaming_outofcore            # full 500M demo
       python -m betacores_tpu_torch.examples.streaming_outofcore --n 20_000_000 --chunk 5_000_000
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                          make_incremental_builder, merge_reduce_build)
from betacores_tpu_torch.evaluation import reverse_forward_kl
from betacores_tpu_torch.examples._common import add_port_flags, device_line, parse_mesh, sync
from betacores_tpu_torch.inference import gaussian_conjugate_sampler
from betacores_tpu_torch.models import gaussian as gmod
from betacores_tpu_torch.utils import Timings


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=25_000_000)
    ap.add_argument("--n-single", type=int, default=50_000_000,
                    help="single-shot comparison build size (0 = skip)")
    ap.add_argument("--m-leaf", type=int, default=100)
    ap.add_argument("--m-final", type=int, default=100)
    ap.add_argument("--proj-dim", type=int, default=100)
    ap.add_argument("--opt-itrs", type=int, default=300)
    ap.add_argument("--i0", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--checkpoint", default="",
                    help="npz path: leaf-pass fault tolerance — crash and "
                         "rerun with the same args to resume bit-identically")
    ap.add_argument("--max-union-rows", type=int, default=0,
                    help=">0: hierarchical merge-reduce tree, capping every "
                         "level's working set at this many weighted rows")
    ap.add_argument("--mesh", default="",
                    help="e.g. 8x1: run the MESH-STREAMED leaf pass — rounds of "
                         "n_data simultaneous leaf builds, one rank each (gloo "
                         "processes with --device cpu; NCCL, one rank a card, on "
                         "cards). Incompatible with --checkpoint (per-leaf "
                         "checkpoints need the sequential stream).")
    add_port_flags(ap, seed=False)
    return ap


def _model(d, sig, dev):
    Siginv = torch.from_numpy(np.linalg.inv(sig * np.eye(d)).astype(np.float32)).to(dev)
    logdetSig = float(np.linalg.slogdet(sig * np.eye(d))[1])
    mu0, Sig0inv = torch.zeros(d, device=dev), torch.eye(d, device=dev)
    return (gmod.bundle(Siginv, logdetSig), gaussian_conjugate_sampler(mu0, Sig0inv, Siginv),
            mu0, Sig0inv, Siginv)


def _mesh_build(src, shape, d, sig, cfg, C, m_leaf, m_final, max_union_rows, seed):
    """One rank's mesh-streamed build over the host rows ``src`` (an array,
    or the path of a memory-mapped .npy); the final state as numpy."""
    from betacores_tpu_torch.parallel import make_mesh

    data = np.load(src, mmap_mode="r") if isinstance(src, str) else src
    mesh = make_mesh(*shape)
    model, sampler, *_ = _model(d, sig, mesh.device)
    st, _, _ = merge_reduce_build(seed, data, model, sampler, leaf_config=cfg, final_config=cfg,
                                  chunk_size=C, m_leaf=m_leaf, m_final=m_final,
                                  st_leaf=init_state(m_leaf, d, device=mesh.device),
                                  mesh=mesh, max_union_rows=max_union_rows)
    return st.wts.cpu().numpy(), st.pts.cpu().numpy()


def main(argv=None):
    """Returns the JSON record, and ``post_full`` (the exact posterior)."""
    args = parser().parse_args(argv)
    dev = args.device
    mesh_shape = None
    if args.mesh:
        if args.checkpoint:
            raise SystemExit("--mesh is incompatible with --checkpoint")
        mesh_shape = parse_mesh(args.mesh)
        from betacores_tpu_torch.parallel import world_backend

        backend = world_backend(dev, mesh_shape[0] * mesh_shape[1])

    N, d, C = args.n, args.d, args.chunk
    gb = N * d * 4 / 2**30
    print(f"N={N:,} d={d} f32 = {gb:.1f} GiB host data, chunks of {C:,}")

    # ---- generate in host RAM, chunk by chunk, tracking the exact
    # full-data sufficient statistic (conjugate gaussian: only sum_n x_n
    # and N are needed for the posterior) ----
    rng = np.random.default_rng(args.seed)
    sig = 2.0
    t0 = time.perf_counter()
    data = np.empty((N, d), dtype=np.float32)
    xsum = np.zeros(d, dtype=np.float64)
    gen_chunk = 10_000_000
    for i in range(0, N, gen_chunk):
        j = min(i + gen_chunk, N)
        blk = rng.standard_normal((j - i, d), dtype=np.float32) * np.sqrt(sig)
        blk += 1.0  # common mean offset so the posterior moves off the prior
        data[i:j] = blk
        xsum += blk.sum(axis=0, dtype=np.float64)
    t_gen = time.perf_counter() - t0
    print(f"generated in {t_gen:.0f}s")

    model, sampler, mu0, Sig0inv, Siginv = _model(d, sig, dev)
    Siginv64 = Siginv.cpu().numpy().astype(np.float64)

    def exact_post(n_rows, xs):
        """Conjugate posterior from the sufficient statistic only."""
        prec = np.eye(d) + n_rows * Siginv64
        mu = np.linalg.solve(prec, Siginv64 @ xs)
        return gmod.GaussianPosterior(
            mu=torch.from_numpy(mu.astype(np.float32)).to(dev),
            prec_chol=torch.from_numpy(np.linalg.cholesky(prec).astype(np.float32)).to(dev))

    post_full = exact_post(N, xsum)

    cfg = IncrementalConfig(projection_dim=args.proj_dim,
                            n_subsample_select=1000, n_subsample_opt=200,
                            opt_itrs=args.opt_itrs, i0=args.i0)
    K = -(-N // C)

    # ---- streamed merge-reduce build (out-of-core: one chunk on device
    # at a time) ----
    tm = Timings()
    sync(dev)
    t0 = time.perf_counter()
    if mesh_shape is not None:
        from betacores_tpu_torch.parallel import run_world

        print(f"mesh-streamed leaf pass over {{'data': {mesh_shape[0]}, 'samp': "
              f"{mesh_shape[1]}}} ({K} leaves in rounds of {mesh_shape[0]}; {backend})")
        n_ranks = mesh_shape[0] * mesh_shape[1]
        rest = (mesh_shape, d, sig, cfg, C, args.m_leaf, args.m_final,
                args.max_union_rows or None, args.seed)
        if n_ranks == 1:
            w, p = run_world(_mesh_build, 1, backend, (data,) + rest)[0]
        else:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "rows.npy")
                np.save(path, data)
                w, p = run_world(_mesh_build, n_ranks, backend, (path,) + rest)[0]
    else:
        final_state, _, _ = merge_reduce_build(
            args.seed, data, model, sampler, leaf_config=cfg, final_config=cfg,
            chunk_size=C, m_leaf=args.m_leaf, m_final=args.m_final,
            st_leaf=init_state(args.m_leaf, d, dtype=torch.float32, device=dev),
            checkpoint_path=args.checkpoint or None,
            max_union_rows=args.max_union_rows or None, device=dev, timings=tm)
        w = final_state.wts.cpu().numpy()
        p = final_state.pts.cpu().numpy()
    sync(dev)
    t_stream = time.perf_counter() - t0

    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    post_stream = gmod.weighted_post(mu0, Sig0inv, Siginv, as_dev(p), as_dev(w))
    rkl_stream = float(reverse_forward_kl(post_stream, post_full)[0])
    prior = gmod.GaussianPosterior(mu=mu0, prec_chol=torch.eye(d, device=dev))
    rkl_prior = float(reverse_forward_kl(prior, post_full)[0])
    nnz = int((w > 0).sum())
    card = device_line(dev)
    print(f"streamed build ({N:,} rows, {K} leaves): {t_stream:.0f}s, "
          f"{nnz} points, rKL={rkl_stream:.4g} (prior rKL={rkl_prior:.4g}) [{card}]")

    # ---- single-shot comparison at a size that fits the device ----
    result = {"n": N, "d": d, "chunk": C, "gib": round(gb, 1),
              "t_generate_s": round(t_gen, 1),
              "t_stream_s": round(t_stream, 1),
              "rkl_stream": rkl_stream, "rkl_prior": rkl_prior,
              "nnz_stream": nnz}
    if args.n_single:
        Ns = args.n_single
        post_s = exact_post(Ns, data[:Ns].sum(axis=0, dtype=np.float64))
        sync(dev)
        t0 = time.perf_counter()
        b = make_incremental_builder(torch.from_numpy(data[:Ns]).to(dev), model, sampler, cfg)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        st = b.build(init_state(args.m_final, d, dtype=torch.float32, device=dev),
                     args.m_final, b.generator_draws(gen))
        ws = st.wts.cpu().numpy()
        ps = st.pts.cpu().numpy()
        t_single = time.perf_counter() - t0
        post_1 = gmod.weighted_post(mu0, Sig0inv, Siginv, as_dev(ps), as_dev(ws))
        rkl_single = float(reverse_forward_kl(post_1, post_s)[0])
        print(f"single-shot at N={Ns:,}: {t_single:.0f}s, "
              f"{int((ws > 0).sum())} points, rKL={rkl_single:.4g} "
              f"(vs its own exact posterior) [{card}]")
        result.update({"n_single": Ns, "t_single_s": round(t_single, 1),
                       "rkl_single": rkl_single})

    print(json.dumps(result))
    return dict(result, post_full=post_full, timings=tm)


if __name__ == "__main__":
    main()
