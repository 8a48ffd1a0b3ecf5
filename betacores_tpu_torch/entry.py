"""Entry points of the port (counterpart of __graft_entry__.py).

``entry()`` returns one beta-Cores build iteration on the flagship
workload (select + Adam weight refinement, Laplace posterior re-fits
included) over contaminated Bayesian logistic regression, at tiny shapes:
on a card every Adam step is one launch of the fused step kernel K1
(csrc/logreg_adam_step.cu). ``dryrun_multichip(n)`` runs the sharded
subsystems (data-parallel N axis x sample-parallel S axis, distributed
greedy argmax, psum-reduced residuals, and the rest of ``parallel/``) one
tiny step each on an n-rank mesh: on the card (the default) an NCCL world
of n ranks, one a card, which raises, naming the card count, when this
machine has fewer than n cards; with ``device="cpu"`` n processes on the
CPU joined by gloo (where the reference re-executes itself on a virtual
n-device CPU mesh). It never moves to the CPU unasked.

Usage: python -m betacores_tpu_torch.entry [--device cpu] [--n N]
"""

from __future__ import annotations

import argparse
import os

import torch

# the flagship iteration's shapes (__graft_entry__.py::entry): rows,
# features, samples, select and refinement subsamples, Adam steps, slots, beta
N_ROWS, D_FEAT, S, N_SEL, N_OPT, OPT_ITRS, SLOTS, BETA = 256, 8, 32, 64, 32, 10, 16, 0.5
SMOKE_ENV = "_BETACORES_DRYRUN_SMOKE"


def config():
    """The flagship iteration's ``IncrementalConfig``."""
    from betacores_tpu_torch.coresets import IncrementalConfig

    return IncrementalConfig(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
                             opt_itrs=OPT_ITRS, i0=1.0, use_beta=True)


def _problem(n: int, d: int, device, seed: int = 0):
    """(Z, model, sampler): n contaminated logistic rows (10 % corrupted)
    made on ``device`` from a generator seeded ``seed``."""
    from betacores_tpu_torch.data import gen_synthetic_logreg, perturb_logreg
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.models import logreg

    g = torch.Generator(device=device).manual_seed(seed)
    X, y, _ = gen_synthetic_logreg(g, n, d=d, dtype=torch.float32)
    _, _, Z, _ = perturb_logreg(g, X, y, f_rate=0.1)
    return Z, logreg.bundle(), logreg_laplace_sampler()


def make_entry_builder(Z: torch.Tensor):
    """The flagship iteration's builder over rows ``Z`` (on their device)."""
    from betacores_tpu_torch.coresets import make_incremental_builder
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.models import logreg

    return make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), config())


def entry(device=None):
    """(fn, example_args): ``fn(draws, state) -> state`` is one full
    beta-coreset build iteration on ``device`` (None: the card; without
    CUDA it raises). ``draws`` is a ``torch.Generator`` on that device or
    a draws provider of coresets/incremental.py (``FixedDraws``); the
    example arguments are a generator seeded 1 and an empty 16-slot state.
    ``fn.builder`` is the builder it runs."""
    from betacores_tpu_torch.coresets import init_state
    from betacores_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    Z, _, _ = _problem(N_ROWS, D_FEAT, dev)
    builder = make_entry_builder(Z)
    state = init_state(SLOTS, D_FEAT, beta=BETA, dtype=Z.dtype, device=dev)

    def fn(draws, st):
        if isinstance(draws, torch.Generator):
            draws = builder.generator_draws(draws)
        return builder.build(st, 1, draws)

    fn.builder = builder
    return fn, (torch.Generator(device=dev).manual_seed(1), state)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Make an n-rank mesh (data x samp axes, ``auto_mesh_shape``) on
    ``device`` (``parallel.world_backend``: NCCL ranks on n cards, or gloo
    ranks on the CPU), run the full sharded beta-coreset step over it on
    tiny shapes, then each other sharded subsystem one tiny step, in the
    reference's order. With the
    environment's ``_BETACORES_DRYRUN_SMOKE=1`` (a test switch) only the
    sharded build and the weighted sharded build run. Prints, as its last
    line, where it ran (platform, backend and ranks) and the subsystems;
    returns that record. Raises if a rank fails, and before any rank
    starts when the card is asked for and this machine has fewer than
    ``n_devices`` cards."""
    from betacores_tpu_torch.parallel import run_world, world_backend

    backend = world_backend(device, n_devices)
    platform = torch.device(device).type
    smoke = os.environ.get(SMOKE_ENV) == "1"
    ran = run_world(_dryrun_rank, n_devices, backend, (n_devices, smoke))[0]
    rec = {"platform": platform, "backend": backend, "ranks": n_devices,
           "smoke": smoke, "subsystems": ran}
    print(f"dryrun_multichip ok: platform {platform}, {n_devices} ranks over {backend}, "
          f"{'smoke mode, ' if smoke else ''}subsystems {', '.join(ran)}")
    return rec


def _dryrun_rank(n_devices: int, smoke: bool) -> list:
    """One rank of ``dryrun_multichip``: the subsystems it ran, in order."""
    import dataclasses

    from betacores_tpu_torch.coresets import init_state
    from betacores_tpu_torch.parallel import (auto_mesh_shape, make_mesh,
                                              make_sharded_incremental_builder, shard_data,
                                              shard_weights)

    n_data, n_samp = auto_mesh_shape(n_devices)
    mesh = make_mesh(n_data, n_samp)
    dev = mesh.device
    Z, model, sampler = _problem(16 * n_data + 3, 8, dev)  # deliberately non-divisible N
    d = Z.shape[1]
    cfg = dataclasses.replace(config(), projection_dim=8 * n_samp, n_subsample_select=8 * n_data,
                              n_subsample_opt=4 * n_data, opt_itrs=5)
    data_sharded, n_true = shard_data(Z, mesh)
    st0 = lambda: init_state(16, d, beta=BETA, dtype=Z.dtype, device=dev)
    ran = []

    def check(name, m):
        if int(m) < 1:
            raise AssertionError(f"{name} selected no point")
        ran.append(name)

    build = make_sharded_incremental_builder(data_sharded, n_true, model, sampler, cfg, mesh)
    check("sharded build", build.build(st0(), 1, build.generator_draws(2)).m)

    # weighted base data through the sharded path (merge-reduce unions /
    # importance-weighted rows at multi-rank scale)
    uw = shard_weights(torch.ones(Z.shape[0], dtype=Z.dtype, device=dev), mesh)
    build_w = make_sharded_incremental_builder(data_sharded, n_true, model, sampler, cfg, mesh,
                                               data_weights=uw)
    check("weighted sharded build", build_w.build(st0(), 1, build_w.generator_draws(2)).m)
    if smoke:
        return ran

    # FULL-DATA select + FULL-GRADIENT optimize: every shard projects all
    # its valid local rows, the exact residual meets in a psum over data
    cfg_full = dataclasses.replace(cfg, n_subsample_select=None, n_subsample_opt=None)
    build_full = make_sharded_incremental_builder(data_sharded, n_true, model, sampler,
                                                  cfg_full, mesh)
    check("full-data full-gradient sharded build",
          build_full.build(st0(), 1, build_full.generator_draws(2)).m)

    # distributed-GIGA Hilbert and the lane-sharded BPSVI batch
    from betacores_tpu_torch.coresets import BPSVIConfig
    from betacores_tpu_torch.parallel import ShardedHilbertCoreset, make_sharded_bpsvi_batch

    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    aux0 = torch.zeros(d, dtype=Z.dtype, device=dev)
    samples, _ = sampler(gen(3), 8 * n_samp, torch.zeros(1, dtype=Z.dtype, device=dev),
                         torch.zeros((1, d), dtype=Z.dtype, device=dev), aux0)
    sh = ShardedHilbertCoreset(data_sharded, n_true, model, samples, mesh, beta=BETA)
    sh.build(3)
    check("sharded Hilbert", sh.size())
    batch = make_sharded_bpsvi_batch(
        Z, model, sampler,
        BPSVIConfig(projection_dim=8 * n_samp, n_subsample_opt=16, opt_itrs=3, i0=1.0), mesh)
    wts, _, _ = batch(gen(4), [1, 2, 3], 3, aux0)
    if tuple(wts.shape) != (3, 3):
        raise AssertionError(f"sharded BPSVI batch shape {tuple(wts.shape)}")
    ran.append("sharded BPSVI lanes")

    # sharded GROUP-mode build (batch selection / data valuation at scale)
    from betacores_tpu_torch.coresets import group_ids_from_groups, init_group_state
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.parallel import make_sharded_group_builder, shard_group_ids

    n_rows = Z.shape[0]
    gp = Groups.from_lists([list(range(i, min(i + 4, n_rows))) for i in range(0, n_rows, 4)],
                           dev)
    gid = shard_group_ids(group_ids_from_groups(gp, n_rows), mesh, gp.n_groups)
    gbuild = make_sharded_group_builder(data_sharded, gid, n_true, gp, model, sampler, cfg, mesh)
    gst = gbuild.build(init_group_state(st0(), gp.n_groups), 1, gbuild.generator_draws(6))
    check("sharded group build", gst.core.m)

    # lane-sharded Sparse-Hamiltonian-Flow training (MC lanes over the mesh)
    from betacores_tpu_torch.inference import (SHFConfig, init_shf_params,
                                               make_sharded_shf_trainer)
    from betacores_tpu_torch.models import logreg

    shf_cfg = SHFConfig(n_blocks=2, n_leapfrog=2, n_mc=n_devices, n_batch=8,
                        learning_rate=1e-2)
    shf_p = init_shf_params(Z[:4], d, Z.shape[0], shf_cfg)
    shf_train = make_sharded_shf_trainer(Z, logreg.log_joint, mesh, shf_cfg)
    shf_p, shf_tr = shf_train(gen(8), shf_p, 3)
    if tuple(shf_tr.shape) != (3,):
        raise AssertionError(f"sharded SHF trace shape {tuple(shf_tr.shape)}")
    ran.append("sharded flow trainer")

    # mesh-sharded merge-reduce streaming build (leaves over the data lanes)
    from betacores_tpu_torch.coresets import merge_reduce_build

    st_mr, _, _ = merge_reduce_build(9, Z.cpu().numpy(), model, sampler, cfg, cfg,
                                     chunk_size=32, m_leaf=2, m_final=3,
                                     st_leaf=init_state(4, d, beta=BETA, dtype=Z.dtype,
                                                        device=dev), mesh=mesh)
    check("mesh merge-reduce build", st_mr.m)

    # lane-sharded evaluation HMC chains (coreset-posterior eval at scale)
    from betacores_tpu_torch.inference import HMCConfig, run_chains_sharded

    chains, _ = run_chains_sharded(gen(5), lambda th: -0.5 * torch.sum(th * th, dim=-1),
                                   torch.zeros(2, device=dev), n_devices + 1, mesh,
                                   HMCConfig(n_samples=4, n_warmup=4, L_max=4))
    if tuple(chains.shape) != (n_devices + 1, 4, 2):
        raise AssertionError(f"sharded chains shape {tuple(chains.shape)}")
    ran.append("sharded HMC chains")
    return ran


def main(argv=None):
    ap = argparse.ArgumentParser(description="one flagship build iteration, then the "
                                             "multi-rank dry run")
    ap.add_argument("--device", default="cuda", help="cuda (the card, the default) or cpu")
    ap.add_argument("--n", type=int, default=0,
                    help="ranks of the dry run (0: this machine's card count, at least 1)")
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry ok; m =", int(out.m))
    n = args.n or max(1, torch.cuda.device_count() if torch.cuda.is_available() else 1)
    return dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
