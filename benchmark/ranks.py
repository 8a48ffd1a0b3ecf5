"""A cell over several cards: one rank a card, in one process group.

For a workload whose ``chips`` is above 1, the process that runs it
(``run.py``, ``readings.py``) is rank 0: it spawns ``chips - 1`` more
ranks (the spawn start method: a forked child would copy a half-started
CUDA context), and every rank then runs the same runs of harness.run on its
own card, over the port's sharded builder (``ShardedPortImpl``), in step
with the others. The ranks meet in one process group through a FileStore in
a temporary directory: NCCL on cards (on the loopback, as
``parallel.world_of_one`` does), gloo on the CPU, where the tests run the
same code. A gloo group beside it carries the host's control: the set-up's
agreement on the inputs, the barriers around the window, rank 0's stop
flag at each selection boundary, and the gather of each rank's selections,
peak memory, device busy time and loaded modules when the window closes.

Every rank makes the whole dataset and every draw from the seed alike and
keeps its row block (``parallel.shard_data``); the build's state is
replicated, and rank 0's is the one kept and compared. Only rank 0 prints,
and only rank 0 checks.

A rank that dies or hangs ends the run, never hangs it: every collective
has a time limit, rank 0's ``Watchdog`` ends every rank and its own process
(exit code ``FAILED``) once a rank has exited with an error or a phase of a
run has outlived its limit, and every other rank ends itself once rank 0
is gone.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import sys
import tempfile
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import harness

# the time limit of every collective, NCCL's and gloo's
COLLECTIVE_S = 600
# the time limits of a run's phases, in seconds: a checkout's first set-up
# builds the port's kernels; a window lasts --seconds and a little more
SETUP_COLD_S, SETUP_WARM_S = 1100.0, 240.0
WINDOW_SLACK_S, CHECK_S, EXIT_S = 90.0, 240.0, 60.0
# written once a set-up has finished in this checkout: the kernels are built
WARM = harness.REPO / "build" / "bench_cache" / "ranks.warm"
# rank 0's exit code when a rank failed or a phase outlived its limit
FAILED = 5


class Job(NamedTuple):
    """What every rank runs: the cell (harness.Cell's arguments: its
    ``name``, and for the tests ``bench``, ``overrides``, ``limits``), and
    one run a (seed, implementation) pair, the implementation an
    ``impl_factory`` of harness.run (None: the port) that the ranks can
    import by name."""

    cell: dict
    runs: list
    seconds: float
    traced: bool
    witness: bool = False


def mesh_shape(cell: harness.Cell) -> tuple:
    """(data, samp) of the cell's mesh, one rank a card: as many ranks as
    the cell's chips (a test's override may make fewer)."""
    return int(cell.config["mesh"]["data"]), int(cell.config["mesh"]["samp"])


class Watchdog(threading.Thread):
    """Rank 0's guard over the other ranks (module docstring). ``arm``
    starts a phase with its time limit."""

    def __init__(self, procs: list):
        super().__init__(name="ranks-watchdog", daemon=True)
        self.procs = procs
        self.lock = threading.Lock()
        self.phase, self.deadline = "start", float("inf")
        self.done = threading.Event()

    def arm(self, phase: str, seconds: float) -> None:
        with self.lock:
            self.phase, self.deadline = phase, time.monotonic() + seconds

    def remaining(self) -> float:
        with self.lock:
            return max(0.0, self.deadline - time.monotonic())

    def run(self) -> None:
        while not self.done.wait(0.2):
            failed = [(r, p.exitcode) for r, p in enumerate(self.procs, start=1)
                      if p.exitcode not in (None, 0)]
            with self.lock:
                late = time.monotonic() > self.deadline
                phase = self.phase
            if failed or late:
                why = (", ".join(f"rank {r} exited with code {c}" for r, c in failed) if failed
                       else f"the {phase} phase outlived its time limit")
                print(f"ranks: {why}; ending every rank", file=sys.stderr, flush=True)
                end(self.procs)
                os._exit(FAILED)

    def stop(self) -> None:
        self.done.set()
        self.join(5)


def end(procs: list) -> None:
    """Terminates, then kills, each process still alive, and waits for it."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


class Rank:
    """This process's place in the world: its rank, the world's size, its
    device, the port's mesh over the world and the gloo group of the
    host's control. The methods below are collectives of that group: every
    rank calls each at the same point."""

    def __init__(self, rank: int, size: int, device: torch.device, shape: tuple,
                 watch: Optional[Watchdog]):
        from betacores_tpu_torch.parallel import make_mesh

        self.rank, self.size, self.device, self.watch = rank, size, device, watch
        self.control = dist.new_group(backend="gloo",
                                      timeout=datetime.timedelta(seconds=COLLECTIVE_S))
        self.mesh = make_mesh(*shape, device=device)

    @property
    def root(self) -> bool:
        return self.rank == 0

    def arm(self, phase: str, seconds: float) -> None:
        if self.watch is not None:
            self.watch.arm(phase, seconds)

    def agree(self, stop: bool) -> bool:
        """Rank 0's ``stop``, on every rank (the host's clock; no wait on
        the card)."""
        flag = torch.tensor([int(stop)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.control)
        return bool(flag.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def same(self, obj) -> None:
        """Raises unless every rank passed an equal ``obj``."""
        got = self.gather(obj)
        if any(g != got[0] for g in got):
            raise RuntimeError(f"the ranks made different inputs: {got}")

    def window_opens(self, seconds: float) -> None:
        """Every rank's set-up has finished: the window starts together."""
        dist.barrier(group=self.control)
        if self.root:
            WARM.parent.mkdir(parents=True, exist_ok=True)
            WARM.touch()
        self.arm("window", seconds + WINDOW_SLACK_S)

    def program_freed(self) -> None:
        """Every rank has freed its program: rank 0 may check."""
        dist.barrier(group=self.control)
        self.arm("check", CHECK_S)


class ShardedPortImpl(harness.PortImpl):
    """The system under test over several cards: the port's sharded
    incremental builder (``parallel.make_sharded_incremental_builder``)
    over this rank's row block of the data, on the world's mesh, fed the
    benchmark's draws through ``FixedDraws``: the replicated noise, and
    this data shard's refinement rows as indices into its block."""

    def __init__(self, cell: harness.Cell, inputs: harness.Inputs, device):
        from betacores_tpu_torch.parallel import make_sharded_incremental_builder, shard_data

        mesh = cell.world.mesh
        ic, model, sampler, self.st0 = self.parts(cell, device)
        block, n_true = shard_data(inputs.data, mesh)
        self.builder = make_sharded_incremental_builder(block, n_true, model, sampler, ic, mesh)
        idx = inputs.opt_idx
        if idx is not None:       # harness._sharded_rows: global rows, shard by shard
            idx = (idx.reshape(*idx.shape[:-1], mesh.n_data, -1)[..., mesh.ax_d, :]
                   - mesh.ax_d * block.shape[0])
        self.draws = self.replay(inputs._replace(opt_idx=idx), cell.route["selections"])


def _join(rank: int, size: int, shape: tuple, device_type: str, store: str,
          watch: Optional[Watchdog]) -> Rank:
    """Joins the world as ``rank``: NCCL on card ``rank``, or gloo on the CPU."""
    if device_type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank)
        device, backend = torch.device("cuda", rank), "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, size), rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    return Rank(rank, size, device, shape, watch)


def _runs(world: Rank, job: Job, t_start: Optional[float], log: Callable,
          on_result: Optional[Callable]) -> list:
    """The job's runs on this rank; rank 0's results."""
    out = []
    for k, (seed, impl) in enumerate(job.runs):
        t0 = t_start if k == 0 and t_start is not None else time.perf_counter()
        world.arm("set-up", SETUP_WARM_S if WARM.exists() else SETUP_COLD_S)
        cell = harness.Cell(**job.cell)
        cell.world = world
        res = harness.run(cell, seed, job.seconds, job.traced, t0, device=world.device,
                          impl_factory=impl, log=log, witness=job.witness)
        if world.root:
            out.append(res)
            if on_result is not None:
                on_result(seed, impl, res)
    return out


def _orphaned(parent: int) -> None:
    """Ends this rank once rank 0's process is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(FAILED)
        time.sleep(0.5)


def _rank_main(rank: int, size: int, shape: tuple, device_type: str, store: str, job: Job,
               parent: int) -> None:
    """A rank other than 0: the job's runs, then leave the world."""
    threading.Thread(target=_orphaned, args=(parent,), name="ranks-parent", daemon=True).start()
    torch.set_num_threads(2)
    log = lambda msg: print(f"rank {rank}: {msg}", file=sys.stderr, flush=True)  # noqa: E731
    world = _join(rank, size, shape, device_type, store, None)
    try:
        _runs(world, job, None, log, None)
    finally:
        dist.destroy_process_group()


def serve(job: Job, t_start: float, device_type: str = "cuda", log: Optional[Callable] = None,
          on_result: Optional[Callable] = None) -> list:
    """Runs ``job`` over a world of the cell's chips, this process rank 0,
    and returns rank 0's results in order (``on_result(seed, impl, result)``
    is called as each arrives). Raises, or ends the process with
    ``FAILED``, when a rank fails."""
    shape = mesh_shape(harness.Cell(**job.cell))
    size = shape[0] * shape[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, name=f"bench-rank-{r}", daemon=True,
                             args=(r, size, shape, device_type, store, job, os.getpid()))
                 for r in range(1, size)]
        started = []
        watch = Watchdog(started)
        watch.arm("set-up", SETUP_WARM_S if WARM.exists() else SETUP_COLD_S)
        try:
            for p in procs:
                p.start()
                started.append(p)
            watch.start()
            world = _join(0, size, shape, device_type, store, watch)
            try:
                out = _runs(world, job, t_start, log, on_result)
            finally:
                dist.destroy_process_group()
            watch.arm("exit", EXIT_S)
            for p in procs:
                p.join(watch.remaining())
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks 1 to {size - 1} exited with codes {codes}")
            return out
        finally:
            if watch.is_alive():
                watch.stop()
            end(started)
