"""Device time per launch of the step kernels K1 (logreg_adam_step) and K3
(logreg_shard_step_partials) at the main path's shapes, and of K2
(multiclass_projection) at the multiclass path's (N = 2^20, S = 100, K = 5,
d = 10, beta on), through their public wrappers, for comparing two trees
of the port on one card.

    python3 tools/step_kernel_times.py                         # this tree
    PYTHONPATH=<other tree> python3 tools/step_kernel_times.py # another one

The package comes from PYTHONPATH when it is set, so the same script times
an older checkout's kernels (unpacked with ``git archive``) beside this
one's; the operands and the timing come from this tree's chip_smoke.py.
Run the two in turns (old, new, new, old) in one call on one card. Prints
one JSON line: K1 and K3 graph-captured (``chip_smoke._graph_us``) and in a
loop of CUDA events (``chip_smoke._time_ms``), in us; K2 in a loop of CUDA
events, in ms (at ~1 ms it is far longer than its wrapper, and its 419 MB
output far past the 50 MB L2); with the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.append(str(ROOT))  # the package: PYTHONPATH's first, else this tree's


def this_tree_module(name: str):
    """``<this tree>/<name>.py`` as a module, whatever PYTHONPATH holds."""
    path = ROOT / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = this_tree_module("chip_smoke")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("step_kernel_times: no CUDA device")
    from betacores_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_ops, S = cs.step_operands(gen, dev, n_sub=cs.N_OPT, M_buf=cs.M_BUF, n_live=60,
                                 d=cs.N_FEAT, S_true=cs.S, packed=True)
    k3_ops, _ = cs.shard_operands(gen, dev, n_sub=cs.N_OPT, M_buf=cs.M_BUF, n_live=60,
                                  d=cs.N_FEAT, S_loc=cs.S, packed=True)
    z, th = cs.mc_operands(gen, dev, cs.MC_ROWS, cs.S, cs.MC_K, cs.MC_D)
    beta = torch.full((), cs.MC_BETA, dtype=torch.float32, device=dev)
    k1 = lambda: kernels.logreg_adam_step(*k1_ops, S, use_beta=True)
    k3 = lambda: kernels.logreg_shard_step_partials(*k3_ops, S, use_beta=True)
    k2 = lambda: kernels.multiclass_projection(z, th, cs.MC_K, beta, True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(json.dumps({"package": str(Path(kernels.__file__).resolve().parents[1]),
                      "card": smi,
                      "k1_graph_us": cs._graph_us(k1), "k3_graph_us": cs._graph_us(k3),
                      "k1_loop_us": cs._time_ms(k1, 2000) * 1e3,
                      "k3_loop_us": cs._time_ms(k3, 2000) * 1e3,
                      "k2_loop_ms": cs._time_ms(k2, 100)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
