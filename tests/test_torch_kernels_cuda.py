"""The port's CUDA kernel for the fused refinement step
(betacores_tpu_torch/csrc/logreg_adam_step.cu) against its plain twin, on
the card. This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Without a card its tests skip. Tolerance atol = rtol = 2e-4 in float32, the
JAX package's own for this kernel against its composition
(tests/test_pallas_kernels.py): the kernel sums in another order.

``step_operands`` builds the padded operands of tests/test_pallas_kernels.py
and is shared with test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from betacores_tpu_torch.ops import kernels

TOL = dict(atol=2e-4, rtol=2e-4)
ADAM_B1, ADAM_B2 = 0.9, 0.999


def step_operands(rng, d=6, S=50, n_sub=24, M=5, s_pad=128, M_pad=128, n_live=3):
    """The padded operands of tests/test_pallas_kernels.py: a subsample of
    n_sub rows, a coreset buffer of M slots with n_live live ones, noise
    rows padded to s_pad, Adam state padded to M_pad."""
    scaling, beta, lr, t = 41.7, 0.3, 0.37, 5.0
    rows = rng.normal(size=(n_sub + M, d)).astype(np.float32)
    z = np.zeros((s_pad, d), np.float32)
    z[:S] = rng.normal(size=(S, d))
    mu = rng.normal(size=(1, d)).astype(np.float32)
    Lp = np.tril(rng.normal(size=(d, d))).astype(np.float32) + 2 * np.eye(d, dtype=np.float32)
    linv = np.linalg.inv(Lp).astype(np.float32)
    w, m1, m2 = (np.zeros((1, M_pad), np.float32) for _ in range(3))
    w[0, :n_live] = rng.uniform(size=n_live) * 3
    m1[0, :n_live] = 0.1 * rng.normal(size=n_live)
    m2[0, :n_live] = 0.01 * rng.uniform(size=n_live)
    n_sub_pad = n_sub + (-n_sub) % 8
    xin = np.zeros((n_sub_pad + M_pad, d + 1), np.float32)
    xin[:n_sub, :d] = rows[:n_sub]
    xin[:n_sub, d] = 1.0
    xin[n_sub_pad:n_sub_pad + M, :d] = rows[n_sub:]
    xin[n_sub_pad:n_sub_pad + n_live, d] = 1.0
    sc = np.asarray([beta, scaling], np.float32)
    sclr = np.asarray([lr, 1 - ADAM_B1**t, 1 - ADAM_B2**t], np.float32)
    return (xin, z, mu, linv, w, m1, m2, sc, sclr), S


def _torch(ops, device):
    return [torch.from_numpy(a).to(device) for a in ops]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("shape", [
    dict(d=10, S=100, n_sub=200, M=128, s_pad=100, M_pad=128, n_live=60),
    dict(d=6, S=50, n_sub=24, M=5, s_pad=128, M_pad=128, n_live=3),
    dict(d=3, S=37, n_sub=11, M=9, s_pad=37, M_pad=9, n_live=9)])
def test_cuda_kernel_matches_plain_twin(cuda_device, use_beta, shape):
    ops, S = step_operands(np.random.default_rng(42), **shape)
    want = kernels.logreg_adam_step_plain(*_torch(ops, cuda_device), S, use_beta)
    before = kernels.logreg_adam_step.launches
    got = kernels.logreg_adam_step(*_torch(ops, cuda_device), S, use_beta=use_beta)
    torch.cuda.synchronize()
    assert kernels.logreg_adam_step.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **TOL)
        assert (g[0, shape["n_live"]:] == 0.0).all()
