"""A world of ranks for the mesh drivers: where the reference forces a
virtual CPU mesh of n devices in one process, the port runs n processes
joined by a ``torch.distributed`` process group, one rank each.

``world_backend`` picks the backend of a device: gloo for the CPU, NCCL for
cards, and it raises when the cards are fewer than the ranks (NCCL cannot
put two ranks on one card) rather than moving to the CPU. ``run_world``
runs a function in every rank of such a world: a world of one in this
process (``mesh.world_of_one``), a larger one in processes started with the
spawn method, met through a FileStore in a temporary directory, so it needs
no launcher and no network.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from .mesh import world_of_one

TIMEOUT_S = 300


def world_backend(device, n_ranks: int) -> str:
    """"gloo" for ``device`` the CPU, "nccl" for a card when this machine
    has at least ``n_ranks`` of them; otherwise raises, naming the count."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no process-group backend for device {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_ranks:
        raise ValueError(f"a mesh of {n_ranks} ranks on cards needs {n_ranks} cards, this "
                         f"machine has {have} (NCCL puts one rank on a card); ask for "
                         f"--device cpu to run the ranks on the CPU over gloo")
    return "nccl"


def _rank_main(rank: int, world: int, backend: str, store: str, out_dir: str,
               fn: Callable, args: tuple) -> None:
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(rank)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_world(fn: Callable, n_ranks: int, backend: str, args: Sequence = (),
              timeout: float = 3600.0) -> list:
    """``fn(*args)`` in every rank of an ``n_ranks`` world of ``backend``;
    each rank's return value, in rank order (a larger world pickles them,
    so return host data). A world of one runs in this process; a larger
    one in spawned processes (``fn`` must be importable by name there),
    each on card ``rank`` under NCCL. Raises if a rank fails or the world
    outlives ``timeout`` seconds (its processes are then terminated)."""
    if n_ranks == 1:
        with world_of_one(backend):
            return [fn(*args)]
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_ranks, backend, store, tmp, fn, tuple(args)))
                 for r in range(n_ranks)]
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
            raise TimeoutError(f"{len(hung)} of {n_ranks} ranks outlived {timeout} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        out = []
        for r in range(n_ranks):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
