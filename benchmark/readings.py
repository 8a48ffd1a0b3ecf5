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
    factories = {"port": None, "control": harness.ReferenceImpl, **faults.FAULTS}
    if args.impl not in factories:
        print(f"readings.py: no implementation {args.impl!r}: {sorted(factories)}",
              file=sys.stderr)
        return 2
    factory = factories[args.impl]
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(args.workload)
        t0 = time.perf_counter()
        res = harness.run(cell, seed, seconds, False, t0, impl_factory=factory,
                          witness=args.witness)
        print(json.dumps({"workload": cell.name, "impl": args.impl, "seed": seed,
                          "correct": res["correct"], "readings": res["readings"],
                          "checks": res["checks"], "attempted": res["attempted"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
