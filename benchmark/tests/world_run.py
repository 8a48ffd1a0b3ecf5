"""Runs a cell over a gloo world of four ranks on the CPU as run.py runs one
over cards (ranks.serve, this process rank 0), and prints one JSON line a
run: its seed, its implementation and its result.

    python benchmark/tests/world_run.py <seed>:<impl> [<seed>:<impl> ...]

The cell is the tests' own (``cell_args``): the sharded logistic
configuration (configs/logreg_n67m_d10_mesh4x1.json, a 4 x 1 mesh) over the
full-candidate traffic, at tiny.py's size with the step subsample split
evenly over the four shards.

<impl> is ``port``, a fault of faults.py (``MESH_FAULTS``), or ``raises``:
rank 2 raises in the window. Used by test_bench_ranks.py."""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import faults, harness, ranks  # noqa: E402
from benchmark.tests.tiny import TINY  # noqa: E402

NAME = "mesh4x1.tiny"
OVERRIDES = {**TINY["logreg"], "n_subsample_opt": 48}
# the point cells' select limit; a weight limit between the tiny port's
# median gaps on the CPU (1e-5 or so) and the faults' (1e-2 and more)
LIMITS = {"select_gap": {"limit": 0.05}, "later_gap": {"limit": 1e-3}}
SECONDS = 0.3


def cell_args() -> dict:
    """harness.Cell's arguments for the tests' four-card cell."""
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    bench["configs"].append({"name": "mesh4x1", "file":
                             "benchmark/configs/logreg_n67m_d10_mesh4x1.json"})
    bench["workloads"].append({"name": NAME, "config": "mesh4x1", "traffic": "full_select",
                               "chips": 4})
    return {"name": NAME, "bench": bench, "overrides": OVERRIDES, "limits": LIMITS}


def raises(cell, inputs, device):
    """The port, but rank 2 raises at its fourth select (the window's third)."""
    port = harness.system(cell)(cell, inputs, device)
    select, calls = port.select, []

    def select_or_raise(st, it):
        calls.append(it)
        if cell.world.rank == 2 and len(calls) == 4:
            raise RuntimeError("rank 2 fails as the test asks")
        return select(st, it)

    port.select = select_or_raise
    return port


IMPLS = {"port": None, **faults.MESH_FAULTS, "raises": raises}


def main(argv) -> int:
    runs = [(int(seed), IMPLS[impl]) for seed, impl in (a.split(":") for a in argv)]
    names = {id(f): name for name, f in IMPLS.items()}

    def report(seed, impl, res):
        print(json.dumps({"seed": seed, "impl": names[id(impl)], "result": res}), flush=True)

    job = ranks.Job(cell_args(), runs, SECONDS, False)
    ranks.serve(job, time.perf_counter(), device_type="cpu", on_result=report)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
