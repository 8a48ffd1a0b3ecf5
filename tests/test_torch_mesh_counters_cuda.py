"""The mesh's collective counters and the sharded builder's ``refine`` span
(test_torch_mesh_counters.py) on the card, over an NCCL world of one: the
build's steps captured in CUDA graphs count their collectives at each
replay, so the recorded counts agree with the mesh's ``calls`` and with the
same build run eagerly, bytes included. This file imports no JAX, so it
runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_counters_cuda.py

Without a card its tests skip."""

import pytest
import torch

from test_torch_mesh_counters import by_name, check_counts, recorded_build


@pytest.mark.cuda
def test_captured_counters_agree_with_the_mesh_and_the_eager_build():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the steps are captured as CUDA graphs")
    card = torch.device("cuda", 0)
    eager, eager_calls, w_eager = recorded_build(card, False, "nccl")
    captured, calls, w_captured = recorded_build(card, True, "nccl")
    check_counts(eager, eager_calls)
    check_counts(captured, calls)
    assert calls == eager_calls
    assert by_name(captured.counters, "mesh.bytes") == by_name(eager.counters, "mesh.bytes")
    assert any(s.captured for s in captured.spans)
    torch.testing.assert_close(w_captured, w_eager, rtol=1e-4, atol=1e-4)
