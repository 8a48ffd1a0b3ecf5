"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (betacores_tpu_torch).
It measures the port on the NVIDIA cards the cell asks for (over several,
this process is rank 0 of a world it starts: ranks.py) and imports neither
JAX nor the JAX package, in any rank. Without a card (or with fewer than
the cell asks for) it exits 2 and prints no result; when another rank
fails it exits non-zero (ranks.FAILED) and prints no result. The last line
of standard output is one JSON object: ``correct``, ``attempted``
(selections in the window), ``failed`` (compared selections that failed),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, over
several cards ``ranks`` (each rank's selections, peak memory and loaded
forbidden modules), and last ``checks``: each number compared with its
limit, which also close standard error. harness.py describes a run,
compare.py the check.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))
# any kernel cache a library keeps goes inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(CHECKOUT / "build" / "bench_cache" / sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    torch.set_num_threads(2)
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from benchmark import ranks

        job = ranks.Job({"name": cell.name}, [(args.seed, None)], args.seconds,
                        bool(args.trace))
        result = ranks.serve(job, T_START)[0]
    else:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = sorted(set(harness.forbidden_modules()).union(
        *result.get("ranks", {}).get("forbidden", [])))
    if bad:
        print(f"run.py: modules loaded that the benchmark may not load: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
