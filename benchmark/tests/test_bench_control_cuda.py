"""The control on the card: the plain reference in the program's place, in
float32 with TF32 products (the precision below the configurations'
float32 with TF32 off), at each cell's own size and window, comes out not
correct. Run on the card with
``python -m pytest --noconftest -p no:cacheprovider benchmark/tests/test_bench_control_cuda.py``."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control's TF32 products exist only there)")
    seconds = harness.load_json(harness.REPO / "BENCHMARK.json")["run_seconds"]
    res = harness.run(harness.Cell(cell), 2147485001, seconds, False, time.perf_counter(),
                      impl_factory=harness.ReferenceImpl, log=lambda msg: None)
    assert not res["correct"], res["readings"]
