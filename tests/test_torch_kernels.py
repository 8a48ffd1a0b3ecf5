"""The port's fused refinement step (betacores_tpu_torch/ops/kernels.py):
its plain twin against the JAX package's Pallas kernel
``logreg_adam_step_fused`` (interpret mode on the CPU), and its operand
packers against the JAX packers. The CUDA kernel against the twin is in
test_torch_kernels_cuda.py, which imports no JAX so that it runs on the card.

Tolerance atol = rtol = 2e-4 in float32, the JAX package's own for this
kernel against its composition (tests/test_pallas_kernels.py): the two
compute the same function with sums in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.ops import pallas_kernels as jk
from betacores_tpu_torch.ops import kernels
from test_torch_kernels_cuda import step_operands

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _torch(ops, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in ops]


@pytest.mark.parametrize("use_beta", [True, False])
def test_plain_twin_matches_pallas_kernel(rng, use_beta):
    ops, S = step_operands(rng)
    want = jk.logreg_adam_step_fused(*(jnp.asarray(a) for a in ops), S, use_beta=use_beta)
    got = kernels.logreg_adam_step(*_torch(ops), S, use_beta=use_beta)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # padded Adam slots (zero state, zero core rows) stay exactly zero
    for g in got:
        assert (g[0, 3:] == 0.0).all()
    # the step moved the live weights
    assert not np.array_equal(got[0].numpy()[0, :3], ops[4][0, :3])


@pytest.mark.parametrize("use_beta", [True, False])
def test_plain_twin_ignores_padding(rng, use_beta):
    """The twin on the unpadded layout (n_sub rows, M slots, S noise rows)
    equals the twin on the padded one, up to float32 sums taken over
    another length (rtol 1e-5)."""
    d, S, n_sub, M = 6, 50, 24, 5
    ops, _ = step_operands(rng, d=d, S=S, n_sub=n_sub, M=M)
    xin, z, mu, linv, w, m1, m2, sc, sclr = ops
    small = (np.concatenate([xin[:n_sub], xin[n_sub:n_sub + M]]), z[:S], mu, linv,
             w[:, :M], m1[:, :M], m2[:, :M], sc, sclr)
    big = kernels.logreg_adam_step_plain(*_torch(ops), S, use_beta)
    sm = kernels.logreg_adam_step_plain(*_torch(small), S, use_beta)
    for b, s in zip(big, sm):
        np.testing.assert_allclose(s.numpy(), b.numpy()[:, :M], rtol=1e-5, atol=1e-7)


def test_packers_match_jax(rng):
    T, n_sub, M_buf, D, S = 3, 13, 7, 4, 50
    rows = rng.normal(size=(T, n_sub, D)).astype(np.float32)
    pts = rng.normal(size=(M_buf, D)).astype(np.float32)
    slot_mask = np.arange(M_buf) < 4
    want, M_pad_j, R_j = jk.pack_fused_step_rows(jnp.asarray(rows), jnp.asarray(pts),
                                                 jnp.asarray(slot_mask), n_sub, 1.0)
    got, M_pad, R = kernels.pack_fused_step_rows(torch.from_numpy(rows),
                                                 torch.from_numpy(pts),
                                                 torch.from_numpy(slot_mask), n_sub)
    assert (M_pad, R) == (M_pad_j, R_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = rng.normal(size=(T, S, D)).astype(np.float32)
    np.testing.assert_array_equal(
        kernels.pad_fused_step_noise(torch.from_numpy(z), S).numpy(),
        np.asarray(jk.pad_fused_step_noise(jnp.asarray(z), S)))


@pytest.mark.parametrize("T", [25, 500, 2900])
def test_adam_sclr_stack_is_bit_identical(T):
    """Bit for bit over every schedule length below 2958 (see adam_sclr_stack)."""
    from betacores_tpu.utils.opt import step_schedule as jschedule
    from betacores_tpu_torch.utils.opt import step_schedule

    lr_t = step_schedule(1.0, T)
    np.testing.assert_array_equal(lr_t.numpy(), np.asarray(jschedule(1.0, T)))
    got = kernels.adam_sclr_stack(lr_t).numpy()
    want = np.asarray(jk.adam_sclr_stack(jnp.asarray(lr_t.numpy())))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_adam_constants_match_reference():
    assert (kernels.ADAM_B1, kernels.ADAM_B2, kernels.ADAM_EPS) == (
        jk.ADAM_B1, jk.ADAM_B2, jk.ADAM_EPS)


def test_wrapper_has_no_route_off_cpu_or_cuda(rng):
    """A tensor on neither the CPU nor a card raises: there is no fallback."""
    ops, S = step_operands(rng)
    before = kernels.logreg_adam_step.launches
    with pytest.raises(ValueError):
        kernels.logreg_adam_step(*_torch(ops, "meta"), S, use_beta=True)
    kernels.logreg_adam_step(*_torch(ops), S, use_beta=True)   # CPU: the twin
    assert kernels.logreg_adam_step.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "s_true"])
def test_operand_checks_raise(rng, bad):
    ops, S = step_operands(rng)
    t = _torch(ops)
    if bad == "dtype":
        t[1] = t[1].double()
    elif bad == "shape":
        t[4] = t[4][:, :-1]
    elif bad == "contiguous":
        t[3] = t[3].T
    else:
        S = t[1].shape[0] + 1
    with pytest.raises((TypeError, ValueError)):
        kernels._check_operands(*t, S)
