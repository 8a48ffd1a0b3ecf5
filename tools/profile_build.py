"""Device time per launch of the step kernels inside the logistic builds, and
the card's busy share, under torch.profiler.

    python3 tools/profile_build.py                          # this tree
    PYTHONPATH=<other tree> python3 tools/profile_build.py  # another one

Sets up chip_smoke.py's main path (bench.py's configuration: N = 1M rows,
d = 10, S = 100, 500 Adam steps per selection) twice: single-device, with
every step through K1 (logreg_adam_step), and sharded on a (1, 1) NCCL mesh
of one rank, with every step through K3 (logreg_shard_step_partials). Each
runs one warm-up selection, then one profiled selection. Prints one JSON
line per build: the step kernel's launches and mean device time per launch,
the kernel launches per Adam step, and the busy share (the union of all
device activity over the window's wall time). Only device activity is
traced, but the profiler's own host cost still lowers the busy share
against an unprofiled run.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from step_kernel_times import cs  # this tree's chip_smoke.py, whatever PYTHONPATH holds


def profile(tag: str, kernel: str, run) -> dict:
    torch.cuda.synchronize()
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
    out = {"build": tag, "kernel": kernel, "launches": len(mine),
           "device_us_per_launch": sum(mine) / max(1, len(mine)),
           "device_launches_per_step": len(spans) / cs.OPT_ITRS,
           "busy_share": busy / wall_us, "wall_s": wall_us / 1e6}
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
    builder = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg)
    draws = builder.generator_draws(gen)
    builder.build(st0, 1, draws)                                  # warm-up
    profile("single-device", "logreg_adam_step_kernel", lambda: builder.build(st0, 1, draws))
    with cs.world_of_one("nccl"):
        mesh = make_mesh(1, 1)
        Zs, n_true = shard_data(Z, mesh)
        sharded = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                                   logreg_laplace_sampler(), cfg, mesh)
        sdraws = sharded.generator_draws(0)
        sharded.build(st0, 1, sdraws)                             # warm-up
        profile("sharded (1, 1)", "logreg_shard_partials_kernel",
                lambda: sharded.build(st0, 1, sdraws))
    return 0


if __name__ == "__main__":
    sys.exit(main())
