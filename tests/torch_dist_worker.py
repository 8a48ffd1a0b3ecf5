"""Runs sharded builds of the port (betacores_tpu_torch.parallel) in a world
of processes joined by a gloo process group on the CPU, one process per
mesh rank. Used by tests/test_torch_sharded.py and test_torch_mesh.py.

The children are started with the spawn method (the test process has JAX's
threads, which fork would copy half-alive) and import only torch and the
port. They meet through a FileStore, give every collective a 60 s timeout,
and write their results to one pickle per rank; the parent joins them
within a time limit, so a hung collective fails one test rather than the
suite.

A job is a dict of plain data:
  data (N, D) float32, weights (N,) or None, model "logreg",
  ("multiclass", K) or ("gaussian", mu0, Sig0inv, Siginv, logdetSig) with
  numpy arrays (the conjugate sampler), cfg (IncrementalConfig's keyword arguments), state
  (a CoresetState as numpy arrays), itrs, and the draws: either
  sel / opt lists as for ``coresets.FixedDraws`` with the subsample indices
  given per data shard (a list indexed by ax_d, or None), or
  ``generator_seed`` for the builder's own ``generator_draws``; with
  ``trace=True`` the job runs ``build_trace`` in place of ``build``.
Each rank returns, per job: the built state as numpy arrays, the
refinement route, the collective counts of the build, and with ``trace``
the per-iteration (wts, idcs, beta) as numpy arrays. A job with
``kind="mesh"`` instead reports the rank's mesh bookkeeping: its axes,
psums and all_gathers of its rank over both axes, and its blocks of
``data`` and ``weights``; one with ``kind="hilbert"`` runs a
``ShardedHilbertCoreset`` over ``data`` with given ``samples`` (and
``beta``), its ``build_trace(trace)`` and then ``build(itrs)``; one with
``kind="stream"`` runs ``coresets.merge_reduce_build`` over the host array
``data`` with the mesh (``seed``, ``leaf_cfg``, ``final_cfg``, ``chunk``,
``m_leaf``, ``m_final``, ``state`` the leaf template) and reports the final
state, the leaf union and the rank's collective counts.
"""

from __future__ import annotations

import datetime
import pickle
from pathlib import Path

import torch

TIMEOUT_S = 60


def _model(spec):
    from betacores_tpu_torch.inference import (gaussian_conjugate_sampler,
                                               logreg_laplace_sampler,
                                               multiclass_laplace_sampler)
    from betacores_tpu_torch.models import gaussian, logreg, multiclass

    if spec == "logreg":
        return logreg.bundle(), logreg_laplace_sampler()
    if spec[0] == "gaussian":
        _, mu0, Sig0inv, Siginv, logdet = spec
        t = torch.from_numpy
        return (gaussian.bundle(t(Siginv), logdet),
                gaussian_conjugate_sampler(t(mu0), t(Sig0inv), t(Siginv)))
    _, K = spec
    return multiclass.bundle(K), multiclass_laplace_sampler(K)


def _draws(job, ax_d):
    from betacores_tpu_torch.coresets import FixedDraws

    t = lambda a: torch.from_numpy(a)
    pick = lambda idx: None if idx is None else t(idx[ax_d])
    return FixedDraws([(t(z), pick(idx)) for z, idx in job["sel"]],
                      [(t(z), pick(idx)) for z, idx in job["opt"]])


def mesh_report(job, mesh):
    from betacores_tpu_torch.parallel import (DATA_AXIS, SAMP_AXIS, shard_data,
                                              shard_weights)

    x = torch.tensor([float(mesh.rank)])
    block, n_true = shard_data(torch.from_numpy(job["data"]), mesh)
    return {"ax": (mesh.ax_d, mesh.ax_s), "rank": mesh.rank,
            "psum": {a: mesh.psum(x, a).tolist() for a in (DATA_AXIS, SAMP_AXIS)},
            "gather": {a: mesh.all_gather(x, a)[:, 0].tolist() for a in (DATA_AXIS, SAMP_AXIS)},
            "unchanged": x.tolist(), "calls": dict(mesh.calls),
            "block": block.numpy(), "n_true": n_true,
            "u_block": shard_weights(torch.from_numpy(job["weights"]), mesh).numpy()}


def hilbert_report(job, mesh):
    """A ShardedHilbertCoreset over ``data`` with ``samples`` (and ``beta``):
    ``trace`` iterations of ``build_trace`` (this rank's block of each row),
    then ``itrs`` more of ``build``; the weights, error, size and get() after
    each, and the latch."""
    from betacores_tpu_torch.parallel import ShardedHilbertCoreset, shard_data

    data, n_true = shard_data(torch.from_numpy(job["data"]), mesh)
    model, _ = _model(job["model"])
    sh = ShardedHilbertCoreset(data, n_true, model, torch.from_numpy(job["samples"]), mesh,
                               beta=job.get("beta"))
    out = {"trace": sh.build_trace(job["trace"]).numpy(), "w_trace": sh.weights()}
    sh.build(job["itrs"])
    return dict(out, w=sh.weights(), error=sh.error(), size=sh.size(), get=sh.get(),
                latched=sh.reached_numeric_limit)


def stream_report(job, mesh):
    """``merge_reduce_build`` with the mesh-streamed leaf pass."""
    from betacores_tpu_torch.coresets import (IncrementalConfig, merge_reduce_build,
                                             state_from_numpy, state_to_numpy)

    model, sampler = _model(job["model"])
    st, pts, wts = merge_reduce_build(
        job["seed"], job["data"], model, sampler, IncrementalConfig(**job["leaf_cfg"]),
        IncrementalConfig(**job["final_cfg"]), job["chunk"], job["m_leaf"], job["m_final"],
        state_from_numpy(job["state"], device="cpu"), mesh=mesh)
    return {"state": state_to_numpy(st), "leaf_pts": pts.numpy(), "leaf_wts": wts.numpy(),
            "calls": dict(mesh.calls)}


def run_job(job, mesh):
    from betacores_tpu_torch.coresets import (IncrementalConfig, state_from_numpy,
                                             state_to_numpy)
    from betacores_tpu_torch.parallel import (make_sharded_incremental_builder,
                                              shard_data, shard_weights)

    if job.get("kind") == "mesh":
        return mesh_report(job, mesh)
    if job.get("kind") == "hilbert":
        return hilbert_report(job, mesh)
    if job.get("kind") == "stream":
        return stream_report(job, mesh)
    data, n_true = shard_data(torch.from_numpy(job["data"]), mesh)
    u = job.get("weights")
    u = None if u is None else shard_weights(torch.from_numpy(u), mesh)
    model, sampler = _model(job["model"])
    builder = make_sharded_incremental_builder(data, n_true, model, sampler,
                                               IncrementalConfig(**job["cfg"]), mesh,
                                               data_weights=u)
    if "generator_seed" in job:
        draws = builder.generator_draws(job["generator_seed"])
    else:
        draws = _draws(job, mesh.ax_d)
    mesh.calls.clear()
    st0 = state_from_numpy(job["state"], device="cpu")
    out = {"route": builder.route}
    if job.get("trace"):
        st, trace = builder.build_trace(st0, job["itrs"], draws)
        out["trace"] = [t.numpy() for t in trace]
    else:
        st = builder.build(st0, job["itrs"], draws)
    return dict(out, state=state_to_numpy(st), calls=dict(mesh.calls))


def _worker(rank, world, store_path, n_data, n_samp, jobs, out_dir):
    import torch.distributed as dist

    from betacores_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(n_data, n_samp)
        out = {"ax": (mesh.ax_d, mesh.ax_s),
               "jobs": {name: run_job(job, mesh) for name, job in jobs.items()}}
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_world(n_data: int, n_samp: int, jobs: dict, tmp_dir, timeout: float = 600.0):
    """Runs ``jobs`` on an (n_data, n_samp) mesh of spawned gloo processes;
    returns one result dict per rank, in rank order. Raises if a process
    fails or outlives ``timeout`` seconds (it is then terminated)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp_dir = Path(tmp_dir)
    tmp_dir.mkdir(parents=True, exist_ok=True)
    store = str(tmp_dir / "store")
    world = n_data * n_samp
    procs = [ctx.Process(target=_worker, args=(r, world, store, n_data, n_samp, jobs,
                                               str(tmp_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        for p in procs:
            p.join(max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
            p.join(10)
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} ranks outlived {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}")
    out = []
    for r in range(world):
        with open(tmp_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
