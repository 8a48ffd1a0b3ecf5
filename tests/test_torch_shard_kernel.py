"""K3, the sharded step's shard-local partials
(betacores_tpu_torch/ops/kernels.py::logreg_shard_step_partials): its plain
version against the JAX package's Pallas kernel
``logreg_shard_step_partials`` (interpret mode on the CPU), the
partials-to-gradient identity the sharded builder relies on, the
gradient's precision at the scale of a sharded build over 2^26 rows (K3's
rows shifted by their values at the mode; on the card in
test_torch_kernels_cuda.py), the packers' shard mask, the refit's fallback, and the build cache's hash. The
CUDA kernel against its plain version is in test_torch_kernels_cuda.py.

Tolerances are the JAX package's own (tests/test_pallas_kernels.py): the
partials within atol = rtol = 2e-4 in float32, the assembled gradient
within atol = rtol = 3e-4 of the centred one."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.ops import pallas_kernels as jk
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from betacores_tpu_torch.ops import _build, kernels
from betacores_tpu_torch.ops.projection import center
from test_torch_kernels_cuda import (assemble_shard_gradient, rel_err, shard_operands,
                                     shard_step_at_scale)

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)

SHAPES = {
    "S32": dict(d=6, S=32, n_sub=24, M=5, n_live=3),
    "S100": dict(d=10, S=100, n_sub=200, M=128, n_live=60),
    "ragged": dict(d=7, S=45, n_sub=37, M=19, s_pad=45, M_pad=19, n_live=11),
    "no_rows": dict(d=6, S=50, n_sub=100, M=20, n_live=7, has_rows=0.0),
}


def _torch(ops, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in ops]


def _pallas_shifted(ops, S, use_beta):
    """The Pallas kernel's partials of the raw values less its partials at
    zero noise (every sample at mu: each row's value at the mode), in
    float64: what the port's shifted partials are."""
    run = lambda z: [np.asarray(o, np.float64) for o in jk.logreg_shard_step_partials(
        jnp.asarray(ops[0]), jnp.asarray(z), *(jnp.asarray(a) for a in ops[2:]), S,
        use_beta=use_beta)]
    return [a - b for a, b in zip(run(ops[1]), run(np.zeros_like(ops[1])))]


@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_pallas_kernel(rng, shape, use_beta):
    """The port's partials are the Pallas kernel's with each row shifted by
    its value at the mode: the raw partials less those at zero noise."""
    ops, S = shard_operands(rng, **SHAPES[shape])
    want = _pallas_shifted(ops, S, use_beta)
    got = kernels.logreg_shard_step_partials(*_torch(ops), S, use_beta=use_beta)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    colsum, core, corerow, wcore = got
    n_live = SHAPES[shape]["n_live"]
    # padding is exactly zero: sample columns past S, masked buffer rows
    assert (core[:, S:] == 0).all() and (colsum[:, S:] == 0).all() and (wcore[:, S:] == 0).all()
    assert (core[n_live:] == 0).all() and (corerow[0, n_live:] == 0).all()
    if shape == "no_rows":
        assert (colsum == 0).all()          # a shard without valid rows adds nothing


@pytest.mark.parametrize("use_beta", [True, False])
def test_partials_give_the_centred_gradient(rng, use_beta):
    """tests/test_pallas_kernels.py:161-218 on the port: the partials of two
    sample-column blocks, combined as the sharded builder combines them
    (psum == sum over blocks; g = -(a - (r / S) * b) / S), equal the centred
    gradient of the composed path."""
    d, S, n_sub, M = 6, 64, 24, 5
    n_samp, S_loc = 2, 32
    s_loc_pad, M_pad = 128, 128
    scaling, beta = 17.3, 0.4
    rows = rng.normal(size=(n_sub + M, d)).astype(np.float32)
    slot_mask = np.ones(M, np.float32)
    slot_mask[3:] = 0.0
    z = rng.normal(size=(S, d)).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    Lp = np.tril(rng.normal(size=(d, d))).astype(np.float32) + 2 * np.eye(d, dtype=np.float32)
    linv = np.linalg.inv(Lp).astype(np.float32)
    w = np.zeros((1, M_pad), np.float32)
    w[0, :M] = rng.uniform(size=M) * 2 * slot_mask

    t = torch.from_numpy
    theta = t(mu) + t(z) @ t(linv)
    lik = (logreg.beta_likelihood(t(rows), theta, beta) if use_beta
           else logreg.log_likelihood(t(rows), theta))
    vals = center(lik).numpy()
    vals[n_sub:] *= slot_mask[:, None]
    resid_c = scaling * vals[:n_sub].sum(axis=0) - w[0, :M] @ vals[n_sub:]
    g_ref = -(vals[n_sub:] @ resid_c) / S

    xin = np.zeros((n_sub + M_pad, d + 1), np.float32)
    xin[:n_sub, :d] = rows[:n_sub]
    xin[:n_sub, d] = 1.0
    xin[n_sub:n_sub + M, :d] = rows[n_sub:]
    xin[n_sub:n_sub + M, d] = slot_mask
    sc = np.asarray([beta], np.float32)
    a = np.zeros((1, M_pad), np.float32)
    r = np.zeros((1, M_pad), np.float32)
    b = 0.0
    for ax_s in range(n_samp):
        z_blk = np.zeros((s_loc_pad, d), np.float32)
        z_blk[:S_loc] = z[ax_s * S_loc:(ax_s + 1) * S_loc]
        colsum, core, corerow, wcore = (o.numpy() for o in kernels.logreg_shard_step_partials(
            *_torch((xin, z_blk, mu[None, :], linv, w, sc)), S_loc, use_beta=use_beta))
        r_unc = scaling * colsum - wcore
        a += r_unc @ core.T
        r += corerow
        b += r_unc.sum()
    g = -(a[0, :M] - (r[0, :M] / S) * b) / S
    np.testing.assert_allclose(g, g_ref, atol=3e-4, rtol=3e-4)
    assert (a[0, M:] == 0.0).all() and (r[0, M:] == 0.0).all()


@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_shifted_partials_keep_the_gradientshard_step_at_scale(seed, use_beta):
    """At the scale of 2^26 rows the gradient from the port's partials is
    within 1e-4 of the float64 centred one (measured: 2e-6 to 1.4e-5),
    where the raw partials the Pallas kernel sums give 4e-3 to 0.6: their
    common level, scaled by 3.4e5, leaves float32 too few digits for the
    spread over samples. 1e-4 lies 7 times above the first and 38 times
    below the second."""
    ops, S, scaling, g_ref = shard_step_at_scale(seed, use_beta)
    got = kernels.logreg_shard_step_partials(*_torch(ops), S, use_beta=use_beta)
    assert rel_err(assemble_shard_gradient(got, scaling, S), g_ref) <= 1e-4
    raw = jk.logreg_shard_step_partials(*(jnp.asarray(a) for a in ops), S, use_beta=use_beta)
    assert rel_err(assemble_shard_gradient(raw, scaling, S), g_ref) > 1e-3


def test_wrapper_counts_only_card_launches(rng):
    """On the CPU the wrapper runs the plain version and counts nothing; a
    tensor on neither the CPU nor a card raises."""
    ops, S = shard_operands(rng)
    before = kernels.logreg_shard_step_partials.launches
    with pytest.raises(ValueError):
        kernels.logreg_shard_step_partials(*_torch(ops, "meta"), S, use_beta=True)
    kernels.logreg_shard_step_partials(*_torch(ops), S, use_beta=True)
    assert kernels.logreg_shard_step_partials.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "s_true", "sc"])
def test_operand_checks_raise(rng, bad):
    ops, S = shard_operands(rng)
    t = _torch(ops)
    if bad == "dtype":
        t[0] = t[0].double()
    elif bad == "shape":
        t[2] = t[2][:, :-1]
    elif bad == "contiguous":
        t[3] = t[3].T
    elif bad == "sc":
        t[5] = torch.zeros(2)
    else:
        S = t[1].shape[0] + 1
    with pytest.raises((TypeError, ValueError)):
        kernels._check_shard_operands(*t, S)


@pytest.mark.parametrize("has_rows", [0.0, 1.0])
def test_pack_with_shard_mask_matches_jax(rng, has_rows):
    """pack_fused_step_rows' sub_mask is the reference's: a 0-d mask on the
    subsample rows; without it the packing is the unsharded one."""
    T, n_sub, M_buf, D = 3, 13, 7, 4
    rows = rng.normal(size=(T, n_sub, D)).astype(np.float32)
    pts = rng.normal(size=(M_buf, D)).astype(np.float32)
    slot_mask = np.arange(M_buf) < 4
    want, M_pad_j, R_j = jk.pack_fused_step_rows(
        jnp.asarray(rows), jnp.asarray(pts), jnp.asarray(slot_mask), n_sub,
        jnp.asarray(has_rows, jnp.float32))
    args = (torch.from_numpy(rows), torch.from_numpy(pts), torch.from_numpy(slot_mask), n_sub)
    got, M_pad, R = kernels.pack_fused_step_rows(*args, torch.tensor(has_rows))
    assert (M_pad, R) == (M_pad_j, R_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    default = kernels.pack_fused_step_rows(*args)[0]
    np.testing.assert_array_equal(default.numpy(),
                                  kernels.pack_fused_step_rows(*args, torch.tensor(1.0))[0].numpy())


def test_refit_state_without_fit_inv(rng):
    """A sampler without fit_inv: fit, then L^-1 by a triangular solve,
    equals the fit_inv route."""
    smp = logreg_laplace_sampler()
    pts = torch.from_numpy(rng.normal(size=(9, 4)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=9).astype(np.float32))
    aux = torch.zeros(4)

    class FitOnly:
        fit = staticmethod(smp.fit)

    lap_a, linv_a = kernels.make_refit_state(smp, pts)(w, aux)
    lap_b, linv_b = kernels.make_refit_state(FitOnly(), pts)(w, aux)
    assert linv_b.dtype == torch.float32 and linv_b.is_contiguous()
    np.testing.assert_allclose(lap_b.mu.numpy(), lap_a.mu.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(linv_b.numpy(), linv_a.numpy(), rtol=1e-5, atol=1e-6)


def test_build_hash_covers_headers(tmp_path):
    """An edited shared header changes the library name of every source,
    so the kernels that include it are rebuilt; needs no nvcc."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("logreg_adam_step", "logreg_shard_partials")
    before = [_build.source_digest(n, csrc) for n in names]
    assert before == [_build.source_digest(n) for n in names]
    header = csrc / "logreg_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [_build.source_digest(n, csrc) for n in names]
    assert all(a != b for a, b in zip(after, before))
    assert '#include "logreg_common.cuh"' in (csrc / "logreg_shard_partials.cu").read_text()
