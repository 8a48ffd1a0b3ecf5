"""The readings that a cell's limits are set from: runs of one cell on
several seeds in one process, each printed as one JSON line with every
number the check read (``readings``), its limits' verdict and the run's
end-to-end numbers.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 [--seconds 10]
                                  [--impl port|control|<fault>]

``--impl port`` runs the program; ``--impl control`` puts the plain
reference in its place, in float32 with TF32 products (harness.py::
ReferenceImpl), the precision below the configuration's; the name of a
fault of faults.py runs the program broken by it. A run is as
``run.py`` makes it, window and check included; the set-up is shorter
after the first seed, whose imports and kernel loads the others share.
A cell over several cards runs the program and its faults on one world of
ranks (ranks.py) for all the seeds, and the control, which is the
single-device reference, in this process on one card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--impl", default="port",
                    help="port, control, or the name of a fault of faults.py")
    ap.add_argument("--witness", action="store_true",
                    help="also log what the reference run in float32 (TF32 off) reads")
    args = ap.parse_args(argv)

    import torch

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    seconds = args.seconds
    if seconds is None:
        seconds = harness.load_json(harness.REPO / "BENCHMARK.json")["run_seconds"]
    factories = {"port": None, "control": harness.ReferenceImpl, **faults.MESH_FAULTS}
    if args.impl not in factories:
        print(f"readings.py: no implementation {args.impl!r}: {sorted(factories)}",
              file=sys.stderr)
        return 2
    factory = factories[args.impl]
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()

    def report(seed, impl, res):
        nonlocal t0
        print(json.dumps({"workload": args.workload, "impl": args.impl, "seed": seed,
                          "correct": res["correct"], "readings": res["readings"],
                          "checks": res["checks"], "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        t0 = time.perf_counter()

    cell = harness.Cell(args.workload)
    if cell.chips > 1 and args.impl != "control":
        from benchmark import ranks

        if torch.cuda.device_count() < cell.chips:
            print(f"readings.py: {cell.name} needs {cell.chips} CUDA devices", file=sys.stderr)
            return 2
        job = ranks.Job({"name": cell.name}, [(seed, factory) for seed in seeds], seconds,
                        False, witness=args.witness)
        ranks.serve(job, t0, on_result=report)
        return 0
    if args.impl in faults.MESH_FAULTS and args.impl not in faults.FAULTS:
        print(f"readings.py: {args.impl} needs a cell over several cards", file=sys.stderr)
        return 2
    for seed in seeds:
        cell = harness.Cell(args.workload)
        res = harness.run(cell, seed, seconds, False, t0, impl_factory=factory,
                          witness=args.witness)
        report(seed, factory, res)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
