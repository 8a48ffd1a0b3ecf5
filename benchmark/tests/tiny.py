"""Tiny configurations for the CPU tests: the cells' routes at a size a test
run holds (the port runs its kernels' plain versions on the CPU)."""

import time

from benchmark import harness

TINY = {
    "logreg": {"n_rows": 4096, "opt_itrs": 20, "selections": 5, "buffer_slots": 16,
               "n_subsample_select": 200, "n_subsample_opt": 50,
               "groups": {"n_groups": 16, "selections": 3, "buffer_groups": 4, "opt_itrs": 10}},
    "multiclass": {"n_rows": 16384, "opt_itrs": 20, "selections": 5, "buffer_slots": 12,
                   "n_subsample_opt": 50,
                   "groups": {"n_groups": 8, "selections": 3, "buffer_groups": 3,
                              "opt_itrs": 10}},
}
CELLS = ["logreg.subsampled_select", "multiclass.groups_exact", "multiclass.full_select",
         "logreg.groups_exact"]


def tiny_cell(name: str) -> harness.Cell:
    return harness.Cell(name, overrides=TINY[name.split(".")[0]])


def tiny_run(name: str, seed: int = 7, impl_factory=None, traced: bool = False) -> dict:
    return harness.run(tiny_cell(name), seed, 0.2, traced, time.perf_counter(), device="cpu",
                       impl_factory=impl_factory, log=lambda msg: None)
