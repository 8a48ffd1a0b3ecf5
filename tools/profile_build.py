"""Device time per launch of the step kernels inside the logistic builds, and
the card's busy share, under torch.profiler.

    python3 tools/profile_build.py                          # this tree
    PYTHONPATH=<other tree> python3 tools/profile_build.py  # another one

Sets up chip_smoke.py's main path (bench.py's configuration: N = 1M rows,
d = 10, S = 100, 500 Adam steps per selection) twice: single-device, with
every step through K1 (logreg_adam_step), and sharded on a (1, 1) NCCL mesh
of one rank, with every step through K3 (logreg_shard_step_partials). Each
is built twice: with ``graph=False``, every step dispatched from Python,
for the device time per operation as the host paces it, and with the
builder's default on a card, the passes replayed as CUDA graphs, for the
captured pass's busy share beside it. Each runs two warm-up selections (the
second captures), then one profiled selection. Prints one JSON line per
build: whether its passes were captured, the step kernel's launches and mean
device time per launch, the device operations per Adam step, the device
time per Adam step (the union of all device activity over the steps), and
the busy share (that union over the window's wall time). Only device
activity is traced, but the profiler's own host cost still slows the host
(an eager build) and the replays (a captured one), so the same window is
also run without the profiler: ``busy_over_unprofiled_wall`` is the traced
device time over that run's wall time.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from step_kernel_times import cs  # this tree's chip_smoke.py, whatever PYTHONPATH holds


def profile(tag: str, captured: bool, kernel: str, run) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()                                 # the same window without the profiler
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:               # the union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    mine = [e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    out = {"build": tag, "captured": captured, "kernel": kernel, "launches": len(mine),
           "device_us_per_launch": sum(mine) / max(1, len(mine)),
           "device_launches_per_step": len(spans) / cs.OPT_ITRS,
           "device_us_per_step": busy / cs.OPT_ITRS,
           "busy_share": busy / wall_us, "wall_s": wall_us / 1e6,
           "unprofiled_wall_s": plain_us / 1e6, "busy_over_unprofiled_wall": busy / plain_us}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_build: no CUDA device")
    from betacores_tpu_torch import (IncrementalConfig, gen_synthetic_logreg, init_state,
                                     logreg, logreg_laplace_sampler, make_incremental_builder,
                                     make_mesh, make_sharded_incremental_builder,
                                     perturb_logreg, shard_data)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    X, y, _ = gen_synthetic_logreg(gen, cs.N_ROWS, d=cs.N_FEAT)
    X, y, Z, _ = perturb_logreg(gen, X, y, f_rate=0.1)
    del X, y
    cfg = IncrementalConfig(projection_dim=cs.S, n_subsample_select=cs.N_SEL,
                            n_subsample_opt=cs.N_OPT, opt_itrs=cs.OPT_ITRS, i0=1.0,
                            use_beta=True)
    st0 = init_state(cs.M_BUF, cs.N_FEAT, beta=cs.BETA, device=dev)
    from betacores_tpu_torch.parallel import world_of_one

    for graph in (False, None):
        builder = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg,
                                           graph=graph)
        draws = builder.generator_draws(gen)
        builder.build(st0, 2, draws)                              # warm-up, capture
        profile("single-device", builder.graph, "logreg_adam_step_kernel",
                lambda: builder.build(st0, 1, draws))
    with world_of_one("nccl"):
        mesh = make_mesh(1, 1)
        Zs, n_true = shard_data(Z, mesh)
        for graph in (False, None):
            sharded = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                                       logreg_laplace_sampler(), cfg, mesh,
                                                       graph=graph)
            sdraws = sharded.generator_draws(0)
            sharded.build(st0, 2, sdraws)                         # warm-up, capture
            profile("sharded (1, 1)", sharded.graph, "logreg_shard_partials_kernel",
                    lambda: sharded.build(st0, 1, sdraws))
    return 0


if __name__ == "__main__":
    sys.exit(main())
