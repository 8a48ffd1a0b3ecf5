"""Exported learn_beta builds of the Gaussian (float64) and multiclass
models: the artifact equals the live build bit for bit, and fed the JAX
build's draws it builds the JAX artifact's coreset and beta
(tests/torch_learn_beta_export.py). The multiclass build selects over 9000
rows, more than FUSED_MIN_ROWS, so K2's op is in the program, called with
the tensor beta (its CPU kernel the plain version here)."""

import pytest
import torch

from betacores_tpu_torch.ops import kernels
from torch_learn_beta_export import check_against_jax, check_artifact_equals_live, exported
from torch_learn_beta_export import program_ops

torch.set_num_threads(1)

CASES = ["gaussian", "multiclass"]


@pytest.mark.parametrize("name", CASES)
def test_learn_beta_artifact_equals_the_live_build(name):
    check_artifact_equals_live(name)
    e = exported(name)
    if name == "multiclass":
        assert kernels.maybe_fused(e["builder"].data.shape[0])
        assert program_ops(e["blob"]) == {"betacores_torch.multiclass_projection.default"}
    else:
        assert program_ops(e["blob"]) == set()


@pytest.mark.parametrize("name", CASES)
def test_learn_beta_artifact_matches_the_jax_artifact_under_its_draws(name):
    check_against_jax(name)
