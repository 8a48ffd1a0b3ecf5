"""Exported learn_beta builds of the logistic model (subsampled, and with
full-data refinement): the artifact equals the live build bit for bit, and
fed the JAX build's draws it builds the JAX artifact's coreset and beta
(tests/torch_learn_beta_export.py)."""

import pytest
import torch

from torch_learn_beta_export import check_against_jax, check_artifact_equals_live, exported
from torch_learn_beta_export import program_ops

torch.set_num_threads(1)

CASES = ["logistic", "logistic_full_data"]


@pytest.mark.parametrize("name", CASES)
def test_learn_beta_artifact_equals_the_live_build(name):
    check_artifact_equals_live(name)
    # never K1: learn_beta takes the composed route
    assert program_ops(exported(name)["blob"]) == set()


@pytest.mark.parametrize("name", CASES)
def test_learn_beta_artifact_matches_the_jax_artifact_under_its_draws(name):
    check_against_jax(name)
