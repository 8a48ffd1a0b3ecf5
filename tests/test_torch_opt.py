"""The port's projected Adam (betacores_tpu_torch/utils/opt.py::nn_adam)
against the JAX package's nn_adam in float32 and against the float64 NumPy
oracle (oracle/opt.py). The gradient is elementwise and the bias
corrections equal the reference's bit for bit (t < 2958,
test_torch_kernels.py), so the two differ only where XLA's fused update
rounds otherwise (it may contract a multiply and an add): float32 results
agree to a few ulps (rtol 1e-6), float64 ones to round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.utils.opt import nn_adam as jnn_adam
from betacores_tpu.utils.opt import step_schedule as jstep_schedule
from betacores_tpu_torch.utils.opt import nn_adam, step_schedule
from oracle.opt import nn_adam as onn_adam

torch.set_num_threads(1)
N_X, T = 9, 300


@pytest.fixture
def problem():
    rng = np.random.default_rng(4)
    x0 = rng.uniform(0.0, 2.0, size=N_X)
    scale = rng.uniform(0.5, 3.0, size=N_X)
    targets = rng.normal(size=(T, N_X)) - 1.5     # per-step inputs, mostly < 0
    mask = rng.uniform(size=N_X) < 0.6
    return x0, scale, targets, mask


@pytest.mark.parametrize("masked", [False, True])
def test_nn_adam_matches_jax(problem, masked):
    x0, scale, targets, mask = (a.astype(np.float32) if a.dtype != bool else a
                                for a in problem)
    lr = np.array(jstep_schedule(0.3, T, dtype=jnp.float32))

    def jgrad(x, aux, k, xsl):
        return jnp.asarray(scale) * (x - xsl), aux + 1

    def tgrad(x, aux, i, xs_i):
        (target,) = xs_i
        return torch.from_numpy(scale) * (x - target), aux + 1

    want, jaux = jnn_adam(jnp.asarray(x0), jgrad, jnp.asarray(0), jax.random.PRNGKey(0),
                          jnp.asarray(lr), nn_mask=jnp.asarray(mask) if masked else None,
                          xs=jnp.asarray(targets))
    got, taux = nn_adam(torch.from_numpy(x0), tgrad, 0, torch.from_numpy(lr),
                        nn_mask=torch.from_numpy(mask) if masked else None,
                        xs=(torch.from_numpy(targets),))
    assert got.dtype == torch.float32 and taux == int(jaux) == T
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if masked:
        assert (got.numpy()[~mask] < 0).any()    # free coordinates leave the orthant
    assert (got.numpy()[mask] >= 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_nn_adam_matches_oracle(problem, masked):
    """float64 against oracle/opt.py: same update, same order."""
    x0, scale, targets, mask = problem
    lr = step_schedule(0.3, T, dtype=torch.float64, device="cpu")
    want = onn_adam(x0, lambda x, i: scale * (x - targets[i]), T, lambda i: 0.3 / (1.0 + i),
                    nn_mask=mask if masked else None)
    got, _ = nn_adam(torch.from_numpy(x0),
                     lambda x, aux, i: (torch.from_numpy(scale) * (x - torch.from_numpy(targets[i])),
                                        aux),
                     None, lr, nn_mask=torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
