"""Headline benchmark of the PyTorch/CUDA port (betacores_tpu_torch), the
counterpart of bench.py: build an M=100 beta-coreset over N=1M contaminated
logistic-regression rows with bench.py's hyperparameters (d=10, S=100,
n_subsample_select=1000, n_subsample_opt=200, 500 Adam steps per selection,
i0=1.0, beta=0.1, a 128-slot buffer, f_rate=0.1, float32), on one NVIDIA GPU.

    python3 bench_torch.py [--seed 0] [--dedup] [--refit-every K] [--full-data]
                           [--sharded] [--eager]
                           [--selections M] [--n N]

The data is made on the card from ``--seed``. One warm-up build (kernel
builds, library handles, graph captures), then one timed build of all M
selections, timed with CUDA events around ``builder.build``. Each
refinement pass runs as replayed CUDA graphs, one per step (``--eager``:
dispatched op by op from Python, for comparison).

    --dedup          mask selected rows out of the argmax (fills M of M)
    --refit-every K  refit the Laplace posterior every K-th Adam step
    --full-data      select scores all N rows (n_subsample_select=None)
    --sharded        the sharded builder on a (1, 1) mesh, one process in
                     an NCCL process group of one rank
    --selections M   the budget (default 100); --n N the rows (default 1M)

The last line of standard output is one JSON object, as bench.py's:
  {"metric": ..., "value": seconds, "unit": "s", "selected": m, "budget": M,
   "fill": m / M}
Earlier lines, on standard error, carry the card's name and power limit,
the seconds per selection, and the microseconds per Adam step and
milliseconds per select timed alone after the build. It runs on a card or
fails: without one, or on any error, the record has ``value: -1`` and the
exit code is not 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback

import torch

N, D_FEAT, M, S = 1_000_000, 10, 100, 100
N_SUB_SEL, N_SUB_OPT, OPT_ITRS, M_BUF = 1000, 200, 500, 128
BETA, F_RATE, I0 = 0.1, 0.1, 1.0


def metric_name(n: int = N, selections: int = M, device: str = "cuda", dedup: bool = False,
                refit_every: int = 1, full_data: bool = False, sharded: bool = False,
                graph: bool | None = None) -> str:
    """The metric's name: the headline's, with a suffix for every variant
    (and the sizes, when they are not the headline's)."""
    rows = "n1m" if n == N else f"n{n}"
    name = f"bcores_build_{rows}_m{selections}_logreg"
    name += "_fullselect" if full_data else ""
    name += f"_torch_{torch.device(device).type}_seconds"
    name += "_dedup" if dedup else ""
    name += f"_refit{refit_every}" if refit_every != 1 else ""
    name += "_sharded" if sharded else ""
    name += "_eager" if graph is False else ""
    return name


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class _Clock:
    """Seconds between ``start`` and ``stop``: CUDA events on a card, the
    host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.ev[1].record()
            self.ev[1].synchronize()
            return self.ev[0].elapsed_time(self.ev[1]) / 1e3
        return time.perf_counter() - self.t0


def make_data(n: int, dev: torch.device, seed: int):
    """(generator, Z): the (n, d) contaminated rows y * x, made on ``dev``
    from ``seed``; the generator goes on to the build's draws."""
    from betacores_tpu_torch import gen_synthetic_logreg, perturb_logreg

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False    # float32 products in full
    gen = torch.Generator(device=dev).manual_seed(seed)
    X, y, _ = gen_synthetic_logreg(gen, n, d=D_FEAT)
    _, _, Z, _ = perturb_logreg(gen, X, y, f_rate=F_RATE)
    return gen, Z


def run(n: int = N, selections: int = M, device: str = "cuda", seed: int = 0,
        dedup: bool = False, refit_every: int = 1, full_data: bool = False,
        sharded: bool = False, graph: bool | None = None,
        opt_itrs: int = OPT_ITRS) -> dict:
    """One warm-up build and one timed build of ``selections`` selections
    over ``n`` rows on ``device``; returns the JSON record. ``graph`` goes
    to the builder (None: its default)."""
    from betacores_tpu_torch import (IncrementalConfig, init_state, logreg, logreg_laplace_sampler,
                                     make_incremental_builder, make_mesh,
                                     make_sharded_incremental_builder, shard_data)
    from betacores_tpu_torch.parallel import world_of_one

    dev = torch.device(device)
    gen, Z = make_data(n, dev, seed)
    cfg = IncrementalConfig(projection_dim=S,
                            n_subsample_select=None if full_data else N_SUB_SEL,
                            n_subsample_opt=N_SUB_OPT, opt_itrs=opt_itrs, i0=I0,
                            use_beta=True, dedup_select=dedup, refit_every=refit_every)
    model, sampler = logreg.bundle(), logreg_laplace_sampler()
    with contextlib.ExitStack() as stack:
        if sharded:
            stack.enter_context(world_of_one("nccl" if dev.type == "cuda" else "gloo"))
            mesh = make_mesh(1, 1, device=dev)
            Zs, n_true = shard_data(Z, mesh)
            builder = make_sharded_incremental_builder(Zs, n_true, model, sampler, cfg,
                                                       mesh, graph=graph)
            draws = builder.generator_draws(seed)
            log(f"sharded build over mesh {mesh.shape}, refinement route {builder.route}")
        else:
            builder = make_incremental_builder(Z, model, sampler, cfg, graph=graph)
            draws = builder.generator_draws(gen)
        log(f"refinement passes {'captured as CUDA graphs' if builder.graph else 'eager'}")
        st0 = init_state(M_BUF, D_FEAT, beta=BETA, device=dev)
        clock = _Clock(dev)

        clock.start()
        builder.build(st0, selections, draws)           # warm-up: builds, captures
        t_first = clock.stop()
        clock.start()
        st = builder.build(st0, selections, draws)      # timed
        t_build = clock.stop()

        # one select and one refinement pass timed alone, thrice, from the
        # built state
        t_sel = t_opt = 0.0
        for it in range(3):
            clock.start()
            st1 = builder.select(st, draws, it)
            t_sel += clock.stop() / 3
            clock.start()
            builder.optimize(st1, draws, it)
            t_opt += clock.stop() / 3
        if builder.graph:
            n_graphs, capture_seconds = builder.capture_stats()
            log(f"captured {n_graphs} graphs of one step in {capture_seconds:.3f} s; "
                f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB allocated, "
                f"{torch.cuda.max_memory_reserved() / 2**20:.0f} MiB reserved")
    n_sel = int(st.m)
    log(f"first build (with kernel builds and captures): {t_first:.2f} s; build: "
        f"{t_build:.3f} s; selected {n_sel}/{selections} points, "
        f"sum(w)={float(st.wts.sum()):.1f}")
    log(f"{t_build / selections:.4f} s per selection; alone: {t_opt / opt_itrs * 1e6:.1f} us "
        f"per Adam step ({opt_itrs} steps per pass), {t_sel * 1e3:.2f} ms per select")
    if n_sel < selections // 2:
        raise AssertionError(f"degenerate build: only {n_sel} selections")
    if dedup and n_sel != selections:
        raise AssertionError(f"dedup build under-filled: {n_sel}/{selections}")
    if not bool(torch.isfinite(st.wts).all()) or not bool((st.wts >= 0).all()):
        raise AssertionError("the weights are not finite and non-negative")
    return {"metric": metric_name(n, selections, device, dedup, refit_every, full_data,
                                  sharded, graph),
            "value": round(t_build, 3), "unit": "s", "selected": n_sel,
            "budget": selections, "fill": round(n_sel / selections, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--refit-every", type=int, default=1)
    ap.add_argument("--full-data", action="store_true")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="dispatch the refinement steps from Python (graph=False)")
    ap.add_argument("--selections", type=int, default=M)
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args(argv)
    graph = False if args.eager else None
    metric = metric_name(args.n, args.selections, "cuda", args.dedup, args.refit_every,
                         args.full_data, args.sharded, graph)
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is False): "
                               "this benchmark runs only on a card")
        log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True).stdout.strip())
        rec = run(args.n, args.selections, "cuda", args.seed, args.dedup, args.refit_every,
                  args.full_data, args.sharded, graph)
    except Exception as e:  # noqa: BLE001 -- the JSON contract must hold
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": metric, "value": -1.0, "unit": "s",
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
