"""Runs sharded builds of the port (betacores_tpu_torch.parallel) in a world
of processes joined by a gloo process group on the CPU, one process per
mesh rank. Used by tests/test_torch_sharded.py, test_torch_mesh.py,
test_torch_sharded_groups.py and test_torch_sharded_lanes.py.

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
  ``generator_seed`` for the builder's own ``generator_draws`` (with
  ``one_generator`` its replicated generator serves the local draws too);
  with ``trace=True`` the job runs ``build_trace`` in place of ``build``.
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

The rest of ``parallel/`` has job kinds of its own, each reporting its
result and the rank's collective counts: ``kind="group"`` runs
``make_sharded_group_builder`` over ``data`` with the group lists
``groups`` (sel draws' candidates replicated, opt draws' indices per data
shard, or ``generator_seed``; ``trace`` runs ``build_trace``; ``count_fused``
counts the model's fused projections); ``kind="bpsvi"`` runs
``make_sharded_bpsvi_batch`` (``draws``: one ``BPSVIDraws`` of numpy arrays
per lane, or ``generator_seed``); ``kind="chains"`` runs
``run_chains_sharded`` on a Gaussian or weighted-logreg target (``draws``
of all chains, or ``generator_seed``; ``nuts`` picks NUTS); ``kind="shf"``
runs ``make_sharded_shf_trainer`` (``draws`` indexed by rank, or
``generator_seed``); ``kind="shapley"`` runs ``make_dshapley`` or
``make_tmc_shapley`` with the mesh (``draws``: T rounds, or
``generator_seed``). A model spec ``("mvn", d, prior)`` is the NIW family
and ``("call_only", d, samples)`` a deterministic sampler without a noise
split; their jobs' ``sel``/``opt`` give only each shard's subsample
indices, served by ``local_indices``.
"""

from __future__ import annotations

import datetime
import pickle
from pathlib import Path

import numpy as np
import torch

TIMEOUT_S = 60


def _model(spec):
    from betacores_tpu_torch.inference import (gaussian_conjugate_sampler,
                                               logreg_laplace_sampler,
                                               multiclass_laplace_sampler)
    from betacores_tpu_torch.models import gaussian, logreg, multiclass, mvn

    if spec == "logreg":
        return logreg.bundle(), logreg_laplace_sampler()
    t = torch.from_numpy
    if spec[0] == "gaussian":
        _, mu0, Sig0inv, Siginv, logdet = spec
        return (gaussian.bundle(t(Siginv), logdet),
                gaussian_conjugate_sampler(t(mu0), t(Sig0inv), t(Siginv)))
    if spec[0] == "mvn":
        _, d, prior = spec
        return mvn.bundle(d), mvn.mvn_niw_sampler(*(t(np.asarray(v)) for v in prior))
    if spec[0] == "call_only":
        _, d, samples = spec
        return mvn.bundle(d), CallOnly(t(samples))
    _, K = spec
    return multiclass.bundle(K), multiclass_laplace_sampler(K)


class CallOnly:
    """A deterministic sampler without a noise split: the per-step-draw
    route's stand-in for the NIW sampler, drawing nothing itself."""

    def __init__(self, samples):
        self.samples = samples

    def __call__(self, generator, n, wts, pts, aux):
        return self.samples[:n], aux


class ReplayLocal:
    """Draws of the per-step-draw route replayed: the sampler's generator
    (unused by ``CallOnly``) and one shard's subsample indices, served in
    the order the build asks for them."""

    def __init__(self, indices):
        self.replicated = torch.Generator()
        self._next = iter(indices)

    def local_indices(self, n):
        idx = torch.from_numpy(next(self._next))
        assert idx.shape == (n,)
        return idx


def _draws(job, ax_d, sel_per_shard=True):
    from betacores_tpu_torch.coresets import FixedDraws

    t = lambda a: torch.from_numpy(a)
    pick = lambda idx: None if idx is None else t(idx[ax_d])
    sel = pick if sel_per_shard else (lambda idx: None if idx is None else t(idx))
    return FixedDraws([(t(z), sel(idx)) for z, idx in job["sel"]],
                      [(t(z), pick(idx)) for z, idx in job["opt"]])


def _replay_local(job, ax_d):
    """A call-only job's draws: per iteration this shard's select indices
    (if any), then each step's refinement indices (if any)."""
    order = []
    for (_, isel), (_, iopt) in zip(job["sel"], job["opt"]):
        if isel is not None:
            order.append(isel[ax_d])
        if iopt is not None:
            order.extend(iopt[ax_d])
    return ReplayLocal(order)


def group_report(job, mesh):
    """``make_sharded_group_builder`` over ``data`` and ``groups``."""
    from betacores_tpu_torch.coresets import (IncrementalConfig, group_ids_from_groups,
                                             init_group_state, state_from_numpy,
                                             state_to_numpy)
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.parallel import (make_sharded_group_builder, shard_data,
                                              shard_group_ids, shard_weights)

    data, n_true = shard_data(torch.from_numpy(job["data"]), mesh)
    gp = Groups.from_lists(job["groups"], "cpu")
    gid = shard_group_ids(group_ids_from_groups(gp, n_true), mesh, gp.n_groups)
    u = job.get("weights")
    u = None if u is None else shard_weights(torch.from_numpy(u), mesh)
    model, sampler = _model(job["model"])
    fused = [0]
    if job.get("count_fused"):
        inner = model.fused_beta_projection

        def counted(*a):
            fused[0] += 1
            return inner(*a)

        model = model._replace(fused_beta_projection=counted)
    builder = make_sharded_group_builder(data, gid, n_true, gp, model, sampler,
                                         IncrementalConfig(**job["cfg"]), mesh,
                                         data_weights=u)
    draws = (builder.generator_draws(job["generator_seed"]) if "generator_seed" in job
             else _draws(job, mesh.ax_d, sel_per_shard=False))
    gst0 = init_group_state(state_from_numpy(job["state"], device="cpu"), gp.n_groups)
    mesh.calls.clear()
    out = {"route": builder.route, "onehot": builder.onehot is not None}
    if job.get("trace"):
        gst, trace = builder.build_trace(gst0, job["itrs"], draws)
        out["trace"] = [x.numpy() for x in trace]
    else:
        gst = builder.build(gst0, job["itrs"], draws)
    return dict(out, state=state_to_numpy(gst.core), selected=gst.selected.numpy(),
                calls=dict(mesh.calls), fused=fused[0])


def bpsvi_report(job, mesh):
    from betacores_tpu_torch.coresets import BPSVIConfig, BPSVIDraws
    from betacores_tpu_torch.parallel import make_sharded_bpsvi_batch

    model, sampler = _model(job["model"])
    batch = make_sharded_bpsvi_batch(torch.from_numpy(job["data"]), model, sampler,
                                     BPSVIConfig(**job["cfg"]), mesh)
    aux0 = torch.from_numpy(job["aux0"])
    if "generator_seed" in job:
        draws = torch.Generator().manual_seed(job["generator_seed"])
    else:
        draws = [BPSVIDraws(*(None if x is None else torch.from_numpy(x) for x in d))
                 for d in job["draws"]]
    mesh.calls.clear()
    w, p, i = batch(draws, job["sizes"], job["max_size"], aux0)
    return {"wts": w.numpy(), "pts": p.numpy(), "idcs": i.numpy(), "calls": dict(mesh.calls)}


def _logprob(spec):
    """A target mapping (C, d) to (C,): the standard Gaussian, or the
    weighted logistic log joint over (Z, w)."""
    from betacores_tpu_torch.models import logreg

    if spec[0] == "std_normal":
        return lambda th: -0.5 * torch.sum(th * th, dim=-1)
    _, Z, w = spec
    Z, w = torch.from_numpy(Z), torch.from_numpy(w)
    return lambda th: logreg.log_joint(Z, th, w)


def chains_report(job, mesh):
    from betacores_tpu_torch.inference import (HMCConfig, HMCDraws, HMCPhaseDraws,
                                               NUTSConfig, NUTSDraws, NUTSPhaseDraws,
                                               run_chains_sharded)

    nuts = job.get("nuts", False)
    cfg = (NUTSConfig if nuts else HMCConfig)(**job["cfg"])
    if "generator_seed" in job:
        key = torch.Generator().manual_seed(job["generator_seed"])
    else:
        init, phases = job["draws"]
        Phase, Draws = (NUTSPhaseDraws, NUTSDraws) if nuts else (HMCPhaseDraws, HMCDraws)
        key = Draws(torch.from_numpy(init),
                    tuple(Phase(*(torch.from_numpy(x) for x in ph)) for ph in phases))
    mesh.calls.clear()
    samples, stats = run_chains_sharded(key, _logprob(job["target"]),
                                        torch.from_numpy(job["theta0"]), job["n_chains"],
                                        mesh, cfg)
    return {"samples": samples.numpy(), "stats": {k: v.numpy() for k, v in stats.items()},
            "calls": dict(mesh.calls)}


def shf_report(job, mesh):
    from betacores_tpu_torch.inference import (SHFConfig, SHFDraws, SHFParams,
                                               gaussian_log_joint, make_sharded_shf_trainer)

    Siginv = torch.from_numpy(job["Siginv"])
    train = make_sharded_shf_trainer(torch.from_numpy(job["data"]), gaussian_log_joint(Siginv),
                                     mesh, SHFConfig(**job["cfg"]))
    if "generator_seed" in job:
        key = torch.Generator().manual_seed(job["generator_seed"])
    else:
        key = SHFDraws(*(torch.from_numpy(x) for x in job["draws"][mesh.rank]))
    params = SHFParams(*(torch.from_numpy(x) for x in job["params"]))
    mesh.calls.clear()
    params, trace = train(key, params, job["n_steps"])
    return {"params": [x.numpy() for x in params], "trace": trace.numpy(),
            "calls": dict(mesh.calls)}


def shapley_report(job, mesh):
    from betacores_tpu_torch.coresets import group_ids_from_groups
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.valuation import (logreg_laplace_value_fn, make_dshapley,
                                               make_tmc_shapley)
    from betacores_tpu_torch.valuation.shapley import PermutationDraws

    gp = Groups.from_lists(job["groups"], "cpu")
    args = tuple(torch.from_numpy(a) for a in job["value_args"])
    gid = group_ids_from_groups(gp, args[0].shape[0])
    value_fn = logreg_laplace_value_fn(n_samples=job["n_samples"])
    if job["estimator"] == "dshapley":
        est = make_dshapley(gid, gp, value_fn, job["max_groups"], group_cap=job.get("cap"),
                            mesh=mesh, value_args=args)
    else:
        est = make_tmc_shapley(gid, gp, value_fn, job["full_value"], tol=job["tol"],
                               group_cap=job.get("cap"), mesh=mesh, value_args=args)
    if "generator_seed" in job:
        draws = torch.Generator().manual_seed(job["generator_seed"])
    else:
        draws = [PermutationDraws(*(None if x is None else torch.from_numpy(x) for x in d))
                 for d in job["draws"]]
    mesh.calls.clear()
    phis = est(draws, job["T"])
    return {"phis": phis.numpy(), "calls": dict(mesh.calls)}


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


REPORTS = {"mesh": mesh_report, "hilbert": hilbert_report, "stream": stream_report,
           "group": group_report, "bpsvi": bpsvi_report, "chains": chains_report,
           "shf": shf_report, "shapley": shapley_report}


def run_job(job, mesh):
    from betacores_tpu_torch.coresets import (IncrementalConfig, state_from_numpy,
                                             state_to_numpy)
    from betacores_tpu_torch.parallel import (make_sharded_incremental_builder,
                                              shard_data, shard_weights)

    if "kind" in job:
        return REPORTS[job["kind"]](job, mesh)
    data, n_true = shard_data(torch.from_numpy(job["data"]), mesh)
    u = job.get("weights")
    u = None if u is None else shard_weights(torch.from_numpy(u), mesh)
    model, sampler = _model(job["model"])
    builder = make_sharded_incremental_builder(data, n_true, model, sampler,
                                               IncrementalConfig(**job["cfg"]), mesh,
                                               data_weights=u)
    if "generator_seed" in job:
        draws = builder.generator_draws(job["generator_seed"])
        if job.get("one_generator"):
            draws.local = draws.replicated
    elif job["model"][0] == "call_only":
        draws = _replay_local(job, mesh.ax_d)
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
