"""The port's CUDA kernels against their plain versions, on the card: K1,
the fused refinement step (betacores_tpu_torch/csrc/logreg_adam_step.cu),
K2, the multiclass projection (csrc/multiclass_projection.cu), and K3, the
sharded step's shard-local partials (csrc/logreg_shard_partials.cu); and
the sparse NNLS solvers on the card (the CPU's columns, no host read in the
greedy loop, ``nnls_on_support`` at column N - 1); and the MCMC and flow
runs (inference/hmc.py, nuts.py, shf.py): captured equal to eager bit for
bit, and the card equal to the CPU in float64; and the sharded multiclass
group build's K2 route (parallel/groups.py) against its plain version on a
(1, 1) NCCL mesh; and K1's and K2's ``torch.library`` ops and an exported
build (utils/export.py) on the card. This file imports no JAX, so it runs
where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Without a card its tests skip. Tolerances are the JAX package's own for
each kernel against its composition (tests/test_pallas_kernels.py): atol =
rtol = 2e-4 for K1, atol 2e-5 for K2, in float32; the kernels sum in
another order. K3's outputs are held within 2e-4 of each output's largest
magnitude (atol = rtol = 2e-4 relative to it), as chip_smoke.py holds them.

``step_operands`` builds the padded operands of tests/test_pallas_kernels.py
and is shared with test_torch_kernels.py; ``shard_operands`` those of K3,
and ``shard_step_at_scale`` one K3 step of a build over 2^26 rows with its
float64 centred gradient, shared with test_torch_shard_kernel.py.

K1 and K3 run as one thread-block cluster of C CTAs (C from
ops/kernels.py::cluster_size); ``CLUSTER_EDGES`` are the shapes at the
cluster's edges, covering both theta paths (registers for d <= 16 and
S <= 128, shared memory otherwise). ``MC_EDGES`` are K2's: S around the
warp and the block, K and d on both of its theta paths (registers while
K (D + 3) <= 65 and D <= 10, D the even-padded d), N around one row tile,
and the largest S the first K2 took at d = 32, K = 16."""

import numpy as np
import pytest
import torch

from betacores_tpu_torch.models import logreg
from betacores_tpu_torch.ops import kernels
from betacores_tpu_torch.ops.projection import center

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


def shard_operands(rng, S=32, has_rows=1.0, **shape):
    """Operands of one K3 launch (the shard-local partials): those of
    ``step_operands`` without the Adam state, with sc = [beta] and the
    subsample rows' mask set to ``has_rows`` (0: a shard without valid
    rows). Returns (ops, S)."""
    (xin, z, mu, linv, w, _, _, sc, _), S = step_operands(rng, S=S, **shape)
    xin[:xin.shape[0] - w.shape[1], -1] *= has_rows
    return (xin, z, mu, linv, w, sc[:1].copy()), S


# (d, S, n_sub, M, s_pad, M_pad, n_live), C = cluster_size(n_sub_pad + M_pad)
CLUSTER_EDGES = {
    "R_lt_C": dict(d=3, S=32, n_sub=0, M=1, s_pad=32, M_pad=1, n_live=1),        # R 1, C 2
    "M_pad_1": dict(d=1, S=1, n_sub=24, M=1, s_pad=1, M_pad=1, n_live=1),        # C 2
    "M_pad_C+1": dict(d=16, S=128, n_sub=24, M=3, s_pad=128, M_pad=3, n_live=2),  # C 2
    "M_pad_C-1": dict(d=17, S=32, n_sub=200, M=15, s_pad=32, M_pad=15, n_live=9),  # C 16
    "M_pad_C+1_d32": dict(d=32, S=128, n_sub=200, M=17, s_pad=128, M_pad=17,
                          n_live=17),                                             # C 16
    "three_row_batches": dict(d=10, S=100, n_sub=3000, M=128, s_pad=128, M_pad=128,
                              n_live=100)}                                        # C 16


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
    dict(d=3, S=37, n_sub=11, M=9, s_pad=37, M_pad=9, n_live=9),
    *CLUSTER_EDGES.values()])
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


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("shape", [dict(N=1 << 20, S=100, K=5, d=10),
                                   dict(N=700, S=50, K=4, d=6)])
def test_cuda_multiclass_projection_matches_plain(cuda_device, use_beta, shape):
    """K2 at the multiclass path's shape and at the ragged shape of
    tests/test_pallas_kernels.py, beta = 0.3."""
    rng = np.random.default_rng(42)
    N, S, K, d = shape["N"], shape["S"], shape["K"], shape["d"]
    z = np.c_[rng.normal(size=(N, d)), rng.integers(0, K, N)].astype(np.float32)
    th = rng.normal(size=(S, K * d)).astype(np.float32)
    z, th = torch.from_numpy(z).to(cuda_device), torch.from_numpy(th).to(cuda_device)
    beta = torch.full((), 0.3, device=cuda_device)
    want = kernels.multiclass_projection_plain(z, th, K, beta, use_beta)
    before = kernels.multiclass_projection.launches
    got = kernels.multiclass_projection(z, th, K, beta, use_beta)
    torch.cuda.synchronize()
    assert kernels.multiclass_projection.launches == before + 1
    assert got.shape == (N, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=0)


def _mc_operands(device, N, S, K, d, seed=42):
    rng = np.random.default_rng(seed)
    z = np.c_[rng.normal(size=(N, d)), rng.integers(0, K, N)].astype(np.float32)
    th = rng.normal(size=(S, K * d)).astype(np.float32)
    return torch.from_numpy(z).to(device), torch.from_numpy(th).to(device)


def _mc_plan(device, d, K, S):
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    return kernels.mc_plan_built(d, K, S, limit)


# K2's edges: (N, S, K, d, theta in registers?). N "tile-1" / "tile+1" is
# one row short of / past the plan's tile.
MC_EDGES = {
    **{f"S{S}": (1000, S, 5, 10, True) for S in (1, 31, 32, 33, 100, 128, 257)},
    "K2": (1000, 50, 2, 4, True), "K5": (1000, 50, 5, 4, True),
    "K13_d2": (1000, 50, 13, 2, True), "K16_d2_shared": (1000, 50, 16, 2, False),
    "K16_shared": (1000, 50, 16, 4, False),
    **{f"d{d}": (1000, 100, 5, d, d <= 10) for d in (1, 4, 10, 17, 32)},
    "N1": (1, 100, 5, 10, True), "N_tile-1": ("tile-1", 100, 5, 10, True),
    "N_tile+1": ("tile+1", 100, 5, 10, True),
    "shared_N_tile+1": ("tile+1", 100, 5, 17, False),
    "S111_d32_K16": (300, 111, 16, 32, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("case", MC_EDGES.values(), ids=MC_EDGES.keys())
def test_cuda_multiclass_projection_edges(cuda_device, use_beta, case):
    """K2 at the edges of its plan, on the theta path named, within atol
    2e-5 of its plain version (beta = 0.3)."""
    N, S, K, d, in_registers = case
    plan = _mc_plan(cuda_device, d, K, S)
    assert (plan.D > 0) == in_registers
    if isinstance(N, str):
        N = plan.rows + (1 if N == "tile+1" else -1)
    z, th = _mc_operands(cuda_device, N, S, K, d)
    beta = torch.full((), 0.3, device=cuda_device)
    want = kernels.multiclass_projection_plain(z, th, K, beta, use_beta)
    got = kernels.multiclass_projection(z, th, K, beta, use_beta)
    torch.cuda.synchronize()
    assert got.shape == (N, S) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 5, 100), (17, 5, 100), (32, 16, 111), (1, 2, 5811),
                                   (4, 16, 1), (24, 2, 800)])
def test_cuda_multiclass_plan_matches_its_mirror(cuda_device, shape):
    d, K, S = shape
    limit = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert kernels.mc_plan_built(d, K, S, limit) == kernels.mc_plan(d, K, S, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1 << 16, 100, 5, 10), (3000, 111, 16, 32)],
                         ids=["registers", "shared"])
def test_cuda_multiclass_projection_is_bit_identical_across_launches(cuda_device, case):
    """Row means in a fixed order, no atomics: the same bits every launch."""
    N, S, K, d = case
    z, th = _mc_operands(cuda_device, N, S, K, d)
    first = kernels.multiclass_projection(z, th, K, 0.3, True).clone()
    for _ in range(3):
        again = kernels.multiclass_projection(z, th, K, 0.3, True)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_multiclass_projection_one_call_is_one_launch(cuda_device):
    z, th = _mc_operands(cuda_device, 1 << 14, 100, 5, 10)
    beta = torch.full((), 0.3, device=cuda_device)   # made before: a float fills one
    kernels.multiclass_projection(z, th, 5, beta, True)
    torch.cuda.synchronize()
    before = kernels.multiclass_projection.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kernels.multiclass_projection(z, th, 5, beta, True)
        torch.cuda.synchronize()
    assert kernels.multiclass_projection.launches == before + 1
    device_kernels = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
    assert (len(device_kernels) == 1
            and "multiclass_projection_kernel" in device_kernels[0]), device_kernels


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("shape", [
    dict(d=10, S=100, n_sub=200, M=128, n_live=60),
    dict(d=10, S=50, n_sub=100, M=128, n_live=60),
    dict(d=7, S=45, n_sub=37, M=19, s_pad=45, M_pad=19, n_live=11),
    dict(d=6, S=50, n_sub=100, M=20, n_live=7, has_rows=0.0),
    *CLUSTER_EDGES.values()])
def test_cuda_shard_partials_match_plain(cuda_device, use_beta, shape):
    """K3 at the shapes of chip_smoke.py's K3 phase: the (1, 1) full width,
    the (., 2) shape, a ragged one (buffer and sample axes unpadded), a
    shard without rows, and the cluster's edges."""
    ops, S = shard_operands(np.random.default_rng(42), **shape)
    t = _torch(ops, cuda_device)
    want = kernels.logreg_shard_step_partials_plain(*t, S, use_beta)
    before = kernels.logreg_shard_step_partials.launches
    got = kernels.logreg_shard_step_partials(*t, S, use_beta=use_beta)
    torch.cuda.synchronize()
    assert kernels.logreg_shard_step_partials.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= 2e-4 * scale
    colsum, core, corerow, wcore = got
    n_live = shape["n_live"]
    assert (core[:, S:] == 0).all() and (colsum[:, S:] == 0).all() and (wcore[:, S:] == 0).all()
    assert (core[n_live:] == 0).all() and (corerow[0, n_live:] == 0).all()


def assemble_shard_gradient(partials, scaling, S):
    """The sharded builder's gradient from one shard's partials, in
    float32 (parallel/sharded.py::_optimize_fused on a (1, 1) mesh)."""
    colsum, core, corerow, wcore = (o.cpu() if isinstance(o, torch.Tensor)
                                    else torch.from_numpy(np.array(o)) for o in partials)
    r_unc = torch.tensor(scaling, dtype=torch.float32) * colsum - wcore
    a, b = r_unc @ core.T, r_unc.sum(dim=1, keepdim=True)
    return (-(a - (corerow / S) * b) / S)[0].double().numpy()


def shard_step_at_scale(seed, use_beta):
    """One step of a build over 2^26 rows on four cards: 50 subsample rows
    a card scaled by 2^24 / 50, 60 live slots of weights summing to about
    2^26, a posterior of width 0.01 about a mode near theta = 1. Returns
    (K3's operands, S, the scaling, the centred gradient in float64)."""
    rng = np.random.default_rng(seed)
    d, S, n_sub, M, n_live = 10, 100, 56, 128, 60
    scaling = 2.0 ** 24 / 50
    sign = np.where(rng.uniform(size=(n_sub + M, 1)) < 0.8, 1.0, -1.0)
    rows = (sign * (1.0 + rng.normal(size=(n_sub + M, d)))).astype(np.float32)
    mu = (0.9 + 0.1 * rng.normal(size=(1, d))).astype(np.float32)
    linv = (0.01 * np.eye(d) + 0.001 * np.tril(rng.normal(size=(d, d)))).astype(np.float32)
    z = rng.normal(size=(128, d)).astype(np.float32)
    w = np.zeros((1, M), np.float32)
    w[0, :n_live] = rng.uniform(size=n_live) * 2 * 2 ** 26 / n_live
    xin = np.zeros((n_sub + M, d + 1), np.float32)
    xin[:, :d] = rows
    xin[:n_sub + n_live, d] = 1.0
    sc = np.asarray([0.1], np.float32)
    t = lambda a: torch.from_numpy(a).double()
    th = t(z[:S]) @ t(linv) + t(mu)
    lik = (logreg.beta_likelihood(t(rows), th, 0.1) if use_beta
           else logreg.log_likelihood(t(rows), th))
    v = center(lik).numpy() * xin[:, d:]
    resid = scaling * v[:n_sub].sum(0) - w[0].astype(np.float64) @ v[n_sub:]
    return (xin, z, mu, linv, w, sc), S, scaling, -(v[n_sub:] @ resid) / S


def rel_err(g, g_ref):
    return float(np.abs(g - g_ref).max() / np.abs(g_ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_shifted_partials_keep_the_gradient_at_scale(cuda_device, seed, use_beta):
    """K3 on the card at the scale of a sharded build over 2^26 rows: the
    gradient its partials give is within the plain version's 1e-4 of the
    float64 centred one (test_torch_shard_kernel.py)."""
    ops, S, scaling, g_ref = shard_step_at_scale(seed, use_beta)
    got = kernels.logreg_shard_step_partials(*_torch(ops, cuda_device), S, use_beta=use_beta)
    torch.cuda.synchronize()
    assert rel_err(assemble_shard_gradient(got, scaling, S), g_ref) <= 1e-4


def _step_launch(kernel, device, shape):
    """(wrapper call, its kernel's name) for K1 or K3 on ``shape``."""
    if kernel == "K1":
        ops, S = step_operands(np.random.default_rng(7), **shape)
        t = _torch(ops, device)
        return (lambda: kernels.logreg_adam_step(*t, S, use_beta=True)), kernels.logreg_adam_step
    ops, S = shard_operands(np.random.default_rng(7), **shape)
    t = _torch(ops, device)
    return ((lambda: kernels.logreg_shard_step_partials(*t, S, use_beta=True)),
            kernels.logreg_shard_step_partials)


MAIN = dict(d=10, S=100, n_sub=200, M=128, s_pad=128, M_pad=128, n_live=60)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K3"])
@pytest.mark.parametrize("shape", [MAIN, CLUSTER_EDGES["M_pad_C-1"],
                                   CLUSTER_EDGES["three_row_batches"]],
                         ids=["main", "M_pad_C-1", "three_row_batches"])
def test_cuda_step_kernels_are_bit_identical_across_launches(cuda_device, kernel, shape):
    """The cluster sums run in a fixed order with no atomics: the same
    inputs give the same bits on every launch."""
    call, _ = _step_launch(kernel, cuda_device, shape)
    first = [t.clone() for t in call()]
    for _ in range(3):
        again = call()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_cuda_one_wrapper_call_is_one_launch(cuda_device, kernel):
    """One wrapper call puts exactly one kernel on the card (the profiler's
    device events) and adds one to the wrapper's count: three calls under
    the profiler give three kernels of the wrapper's name and three counts.
    A first profiler session is opened and discarded (the tracer's first
    session in a process may miss its first device events)."""
    call, wrapper = _step_launch(kernel, cuda_device, MAIN)
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    before = wrapper.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    assert wrapper.launches == before + 3
    device_kernels = [e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
    name = "logreg_adam_step_kernel" if kernel == "K1" else "logreg_shard_partials_kernel"
    assert len(device_kernels) == 3 and all(name in k for k in device_kernels), device_kernels


# ---------------------------------------------------------------------------
# The refinement passes as replayed CUDA graphs (utils/graphs.py): captured
# equals eager, on the card, for each route at a small size.
# ---------------------------------------------------------------------------

def _logreg_rows(n=1500, d=5):
    rng = np.random.default_rng(42)
    th = rng.normal(size=d)
    X = rng.normal(size=(n, d))
    y = np.where(X @ th + 0.3 * rng.normal(size=n) > 0, 1.0, -1.0)
    return torch.from_numpy((y[:, None] * X).astype(np.float32))


def _mc_rows(n=900, d=4, K=3):
    rng = np.random.default_rng(17)
    Th = 2.0 * rng.normal(size=(K, d))
    X = rng.normal(size=(n, d))
    y = np.argmax(X @ Th.T + rng.gumbel(size=(n, K)), axis=1)
    return torch.from_numpy(np.c_[X, y].astype(np.float32))


def _route(route, device, refit_every, graph):
    """(builder, initial state, draws of seed -> provider) of a small build
    through ``route`` on ``device``; the sharded one needs a process group."""
    from betacores_tpu_torch import (IncrementalConfig, init_state, logreg,
                                     logreg_laplace_sampler, make_incremental_builder,
                                     make_mesh, make_sharded_incremental_builder, multiclass,
                                     multiclass_laplace_sampler, shard_data)

    cfg = IncrementalConfig(projection_dim=40, n_subsample_select=150, n_subsample_opt=150,
                            opt_itrs=25, i0=0.5, use_beta=True, dedup_select=True,
                            refit_every=refit_every)
    if route == "composed":
        K, d = 3, 4
        b = make_incremental_builder(_mc_rows().to(device), multiclass.bundle(K),
                                     multiclass_laplace_sampler(K), cfg, graph=graph)
        st0 = init_state(15, d + 1, beta=0.3, device=device,
                         sampler_aux=torch.zeros(K * d, device=device))
    elif route == "sharded":
        mesh = make_mesh(1, 1, device=device)
        Zs, n_true = shard_data(_logreg_rows().to(device), mesh)
        b = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                             logreg_laplace_sampler(), cfg, mesh, graph=graph)
        assert b.route == "fused"
        return b, init_state(15, 5, beta=0.2, device=device), b.generator_draws
    else:
        b = make_incremental_builder(_logreg_rows().to(device), logreg.bundle(),
                                     logreg_laplace_sampler(), cfg, graph=graph)
        st0 = init_state(15, 5, beta=0.2, device=device)
    return b, st0, lambda seed: b.generator_draws(torch.Generator(device=device)
                                                  .manual_seed(seed))


def _world(route):
    import contextlib

    from betacores_tpu_torch.parallel import world_of_one

    return world_of_one("nccl") if route == "sharded" else contextlib.nullcontext()


@pytest.mark.cuda
@pytest.mark.parametrize("refit_every", [1, 4])
@pytest.mark.parametrize("route", ["fused", "composed", "sharded"])
def test_cuda_captured_build_equals_eager(cuda_device, route, refit_every):
    """Four selections through replayed graphs (the default on a card)
    equal the same selections dispatched from Python under the same draws:
    the same indices and m, weights within 1e-6 max|w|; the step kernel's
    count says one launch per step either way."""
    wrapper = {"fused": kernels.logreg_adam_step, "sharded": kernels.logreg_shard_step_partials,
               "composed": None}[route]
    out = {}
    with _world(route):
        for graph in (None, False):
            b, st0, draws = _route(route, cuda_device, refit_every, graph)
            assert b.graph is (graph is None)
            before = wrapper.launches if wrapper else 0
            out[graph] = b.build(st0, 4, draws(7))
            torch.cuda.synchronize()
            if wrapper:
                assert wrapper.launches - before == 4 * 25
    got, ref = out[None], out[False]
    assert int(got.m) == int(ref.m) == 4 and torch.equal(got.idcs, ref.idcs)
    scale = float(ref.wts.abs().max())
    assert scale > 0 and float((got.wts - ref.wts).abs().max()) <= 1e-6 * scale
    assert float((got.sampler_aux - ref.sampler_aux).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "composed", "sharded"])
def test_cuda_replay_reads_the_refilled_buffers(cuda_device, route):
    """A replay after new draws gives another result (the buffers were
    really refilled), and the first draws again give the first result bit
    for bit."""
    with _world(route):
        b, st0, draws = _route(route, cuda_device, 1, None)
        b.build(st0, 2, draws(1))                      # eager, then captured
        first = b.build(st0, 2, draws(2))              # replayed
        other = b.build(st0, 2, draws(3))
        again = b.build(st0, 2, draws(2))
        torch.cuda.synchronize()
    assert not torch.equal(first.wts, other.wts)
    assert torch.equal(first.wts, again.wts) and torch.equal(first.idcs, again.idcs)


@pytest.mark.cuda
def test_cuda_captured_sharded_float64_build_equals_eager(cuda_device):
    """The captured sharded step on float64 data reads its float32 scale
    from storage the builder keeps: six selections (allocations come and go
    between them) equal the eager build."""
    from betacores_tpu_torch import (IncrementalConfig, init_state, logreg,
                                     logreg_laplace_sampler, make_mesh,
                                     make_sharded_incremental_builder, shard_data)
    from betacores_tpu_torch.parallel import world_of_one

    cfg = IncrementalConfig(projection_dim=40, n_subsample_select=150, n_subsample_opt=150,
                            opt_itrs=25, i0=0.5, use_beta=True, dedup_select=True)
    out = {}
    with world_of_one("nccl"):
        mesh = make_mesh(1, 1, device=cuda_device)
        Zs, n_true = shard_data(_logreg_rows().double().to(cuda_device), mesh)
        for graph in (None, False):
            b = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                                 logreg_laplace_sampler(), cfg, mesh,
                                                 graph=graph)
            assert b.route == "fused" and b.graph is (graph is None)
            st0 = init_state(15, 5, beta=0.2, dtype=torch.float64, device=cuda_device)
            out[graph] = b.build(st0, 6, b.generator_draws(7))
            # churn the allocator between the builders, as a longer build does
            junk = [torch.randn(n, device=cuda_device) for n in (1, 7, 1, 300, 1)]
            del junk
        torch.cuda.synchronize()
    got, ref = out[None], out[False]
    assert got.wts.dtype == torch.float64
    assert int(got.m) == int(ref.m) == 6 and torch.equal(got.idcs, ref.idcs)
    scale = float(ref.wts.abs().max())
    assert scale > 0 and float((got.wts - ref.wts).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_cuda_perturb_logreg_follows_from_the_seed(cuda_device):
    """Rows drawn more than once get the same noise in every run."""
    from betacores_tpu_torch import gen_synthetic_logreg, perturb_logreg

    def make():
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        X, y, _ = gen_synthetic_logreg(gen, 200_000, d=10)
        return perturb_logreg(gen, X, y, f_rate=0.3)[2]

    first = make()
    assert all(torch.equal(first, make()) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [False, True])
def test_cuda_float64_multiclass_block_computes(cuda_device, use_beta):
    """A float64 block of at least FUSED_MIN_ROWS rows through the bundle's
    fused projection launches K2 and returns float64: the float32 result
    cast up."""
    from betacores_tpu_torch import multiclass
    from betacores_tpu_torch.ops.projection import project_beta, project_ll

    K, d, S, N = 5, 10, 100, kernels.FUSED_MIN_ROWS + 37
    z, th = _mc_operands(cuda_device, N, S, K, d)
    model = multiclass.bundle(K)
    beta = torch.tensor(0.3, dtype=torch.float64, device=cuda_device)
    before = kernels.multiclass_projection.launches
    if use_beta:
        got = project_beta(model, z.double(), th.double(), beta)
        want = project_beta(model, z, th, beta.float())
    else:
        got = project_ll(model, z.double(), th.double())
        want = project_ll(model, z, th)
    torch.cuda.synchronize()
    assert kernels.multiclass_projection.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == (N, S)
    assert want.dtype == torch.float32 and torch.equal(got, want.double())


def _family_builder(family, device, graph):
    """(builder, initial state) of a small build of a model family without
    a kernel: the known-covariance Gaussian (conjugate sampler, composed
    route) or the unknown-covariance Gaussian (NIW sampler, per-step-draw
    route)."""
    from betacores_tpu_torch import (IncrementalConfig, gaussian, gaussian_conjugate_sampler,
                                     init_state, make_incremental_builder, mvn)

    rng = np.random.default_rng(11)
    d = 4 if family == "gaussian" else 3
    X = np.vstack([rng.normal(size=(600, d)) * 1.7, rng.normal(size=(60, d)) + 8.0])
    X = torch.from_numpy(X.astype(np.float32)).to(device)
    cfg = IncrementalConfig(projection_dim=32, n_subsample_select=128, n_subsample_opt=64,
                            opt_itrs=25, i0=1.0, use_beta=True, dedup_select=True)
    eye = torch.eye(d, device=device)
    if family == "gaussian":
        model = gaussian.bundle(eye / 3.0, d * float(np.log(3.0)))
        smp, td = gaussian_conjugate_sampler(torch.zeros(d, device=device), eye, eye / 3.0), d
    else:
        model, td = mvn.bundle(d), d + d * d
        smp = mvn.mvn_niw_sampler(torch.zeros(d, device=device), 1.0, 2.0 * eye, d + 4.0)
    b = make_incremental_builder(X, model, smp, cfg, graph=graph)
    return b, init_state(16, d, beta=0.5, device=device,
                         sampler_aux=torch.zeros(td, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gaussian", "niw"])
def test_cuda_captured_family_build_equals_eager(cuda_device, family):
    """Four selections of the Gaussian composed pass and of the NIW
    per-step-draw pass (its steps draw the NIW gamma, normals and
    subsample from the pass's generator, registered with each graph),
    replayed as graphs, equal the same selections dispatched from Python
    from the same generator seed: the same indices and m, weights within
    1e-6 max|w|. A replay after other draws gives another build, and the
    first seed again the first build bit for bit."""
    out = {}
    for graph in (None, False):
        b, st0 = _family_builder(family, cuda_device, graph)
        assert b.graph is (graph is None) and b.per_step is (family == "niw")
        out[graph] = b.build(st0, 4, b.generator_draws(
            torch.Generator(device=cuda_device).manual_seed(7)))
        torch.cuda.synchronize()
    got, ref = out[None], out[False]
    assert int(got.m) == int(ref.m) == 4 and torch.equal(got.idcs, ref.idcs)
    scale = float(ref.wts.abs().max())
    assert scale > 0 and float((got.wts - ref.wts).abs().max()) <= 1e-6 * scale
    b, st0 = _family_builder(family, cuda_device, None)
    draws = lambda seed: b.generator_draws(torch.Generator(device=cuda_device).manual_seed(seed))
    b.build(st0, 2, draws(1))                          # eager, then captured
    first = b.build(st0, 2, draws(2))                  # replayed
    other = b.build(st0, 2, draws(3))
    again = b.build(st0, 2, draws(2))
    torch.cuda.synchronize()
    assert b.capture_stats()[0] >= 1
    assert not torch.equal(first.wts, other.wts)
    assert torch.equal(first.wts, again.wts) and torch.equal(first.idcs, again.idcs)


@pytest.mark.cuda
def test_cuda_argmax_takes_the_first_maximum_and_nan(cuda_device):
    """The greedy solvers' select rests on torch.argmax returning the first
    maximum and treating NaN as the maximum, as jnp.argmax does."""
    for dt in (torch.float32, torch.float64):
        x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0], dtype=dt, device=cuda_device)
        assert int(torch.argmax(x)) == 1
        x[3] = float("nan")
        assert int(torch.argmax(x)) == 3
        big = torch.zeros(1 << 20, dtype=dt, device=cuda_device)
        big[[5, 70000, 900000]] = 2.0
        assert int(torch.argmax(big)) == 5


def _snnls_problem(device, dtype=torch.float64, D=20, N=500):
    g = torch.Generator().manual_seed(3)
    A = torch.randn((D, N), generator=g, dtype=dtype)
    b = A.abs() @ torch.rand(N, generator=g, dtype=dtype)
    return A.to(device), b.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["GIGA", "FrankWolfe", "OrthoPursuit", "LAR", "AccIHT"])
def test_cuda_solver_picks_the_cpu_columns(cuda_device, name):
    """A greedy build on the card takes the columns the same build takes on
    the CPU, in the same order, with weights within 1e-9 of max|w|
    (float64, a problem without ties)."""
    from betacores_tpu_torch import snnls

    traces = []
    for dev in ("cpu", cuda_device):
        A, b = _snnls_problem(dev)
        traces.append(getattr(snnls, name)(A, b).build_trace(12).cpu().numpy())
    cpu, card = traces
    np.testing.assert_array_equal(card > 0, cpu > 0)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-9 * np.abs(cpu).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["GIGA", "FrankWolfe", "OrthoPursuit", "LAR", "AccIHT"])
def test_cuda_greedy_loop_reads_nothing_on_the_host(cuda_device, name):
    """The build loop (snnls.build over a solver's step) runs under
    torch.cuda.set_sync_debug_mode("error"): any host read inside it
    raises. The latch is read after the loop."""
    from betacores_tpu_torch import snnls

    A, b = _snnls_problem(cuda_device, torch.float32)
    w0 = torch.zeros(A.shape[1], dtype=A.dtype, device=cuda_device)
    err = lambda w: torch.linalg.norm(A @ w - b)
    K = min(A.shape)
    if name == "GIGA":
        pre = snnls.giga_precompute(A, b)
        step = lambda w: snnls.giga_step(pre, w, 1e-12)
    elif name == "FrankWolfe":
        pre = snnls.fw_precompute(A, b)
        step = lambda w: snnls.fw_step(pre, w)
    elif name == "OrthoPursuit":
        pre = snnls.orthopursuit.OMPPre(A, A / torch.linalg.norm(A, dim=0), b)
        step = lambda w: snnls.omp_step(pre, w, K)
    elif name == "LAR":
        pre = snnls.lar.LARPre(A, A / torch.linalg.norm(A, dim=0), b)
        step = lambda w: snnls.lar_step(pre, w, K)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if name == "AccIHT":
            w, _ = snnls.iht.aiht_solve_hybrid(A, b, 8, w0, 20, 1e-12)
        else:
            w = snnls.build(step, err, w0, 8).w
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int((w > 0).sum()) > 0 and bool(torch.isfinite(w).all())


@pytest.mark.cuda
def test_cuda_nnls_on_support_keeps_the_last_column(cuda_device):
    """Column N - 1 in a support narrower than the block: on the card the
    padding slots' adds of 0 leave its weight, as on the CPU."""
    from betacores_tpu_torch import snnls

    g = torch.Generator().manual_seed(5)
    D, N = 10, 12
    A = torch.randn((D, N), generator=g, dtype=torch.float64)
    sup = torch.zeros(N, dtype=torch.bool)
    sup[[2, 7, N - 1]] = True
    b = A[:, sup] @ torch.tensor([0.5, 1.5, 2.0], dtype=torch.float64)
    cpu = snnls.nnls_on_support(A, b, sup, 5, n_iters=2000)
    card = snnls.nnls_on_support(A.to(cuda_device), b.to(cuda_device), sup.to(cuda_device),
                                 5, n_iters=2000).cpu()
    assert float(card[N - 1]) > 1.0
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=0, atol=1e-10)


def _group_problem(device, N=9000, K=3, d=4, per=100):
    """A multiclass problem of N >= FUSED_MIN_ROWS rows in groups of
    ``per`` rows (the last rows in no group), its group builder's pieces."""
    from betacores_tpu_torch import flip_labels, gen_synthetic_multiclass

    gen = torch.Generator(device=device).manual_seed(3)
    _, _, Z = gen_synthetic_multiclass(gen, N, d=d, n_classes=K)
    Z, _ = flip_labels(gen, Z, K, 0.2)
    groups = [list(range(g * per, (g + 1) * per)) for g in range(N // per - 1)]
    return Z, groups


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [False, True])
def test_cuda_multiclass_group_select_goes_through_k2(cuda_device, use_beta):
    """The group select of a multiclass build over N = 9000 rows projects
    every row through K2 (one launch a select) and selects what the same
    select through the plain projection selects on the card; the group
    vectors agree within K2's 2e-5 per row times the group's rows."""
    from betacores_tpu_torch import (IncrementalConfig, init_state, multiclass,
                                     multiclass_laplace_sampler)
    from betacores_tpu_torch.coresets import (FixedDraws, init_group_state,
                                              make_group_incremental_builder)
    from betacores_tpu_torch.ops.projection import Groups

    K, d, S = 3, 4, 32
    Z, groups = _group_problem(cuda_device, K=K, d=d)
    gp = Groups.from_lists(groups, device=cuda_device)
    cfg = IncrementalConfig(projection_dim=S, opt_itrs=5, i0=0.5, use_beta=use_beta)
    fused = multiclass.bundle(K)
    plain = fused._replace(fused_ll_projection=None, fused_beta_projection=None)
    smp = multiclass_laplace_sampler(K)
    z = torch.randn((S, K * d), generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    draws = FixedDraws([(z, None)], [])
    out = {}
    for name, model in (("kernel", fused), ("plain", plain)):
        b = make_group_incremental_builder(Z, gp, model, smp, cfg)
        gst = init_group_state(init_state(400, d + 1, beta=0.3, device=cuda_device,
                                          sampler_aux=torch.zeros(K * d, device=cuda_device)),
                               len(groups))
        before = kernels.multiclass_projection.launches
        got = b.select(gst, draws)
        samples, _ = smp.from_noise(z, gst.core.wts, gst.core.pts, gst.core.sampler_aux)
        gv = b.group_vecs(samples, gst.core.beta)
        torch.cuda.synchronize()
        out[name] = (got, gv, kernels.multiclass_projection.launches - before)
    assert out["kernel"][2] == 2 and out["plain"][2] == 0
    assert torch.equal(out["kernel"][0].selected, out["plain"][0].selected)
    assert torch.equal(out["kernel"][0].core.idcs, out["plain"][0].core.idcs)
    assert int(out["kernel"][0].core.m) == 100
    err = float((out["kernel"][1] - out["plain"][1]).abs().max())
    assert err <= 2e-5 * 100, err


@pytest.mark.cuda
@pytest.mark.parametrize("use_beta", [False, True])
def test_cuda_sharded_multiclass_group_build_goes_through_k2(cuda_device, use_beta):
    """The sharded multiclass group build on a (1, 1) NCCL mesh: on its
    samp = 1 route every select and every refinement step projects the
    9000 local rows through K2 (one launch each; the 400-slot buffer stays
    below FUSED_MIN_ROWS), and it builds what the same build through the
    plain projection builds: the same groups and m, weights within
    5e-3 * max|w| (K2 sums in another order, within 2e-5 a row)."""
    from betacores_tpu_torch import (IncrementalConfig, init_state, multiclass,
                                     multiclass_laplace_sampler)
    from betacores_tpu_torch.coresets import (FixedDraws, group_ids_from_groups,
                                              init_group_state)
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.parallel import (make_mesh, make_sharded_group_builder,
                                              shard_data, shard_group_ids, world_of_one)

    K, d, S, T, itrs = 3, 4, 32, 5, 2
    Z, groups = _group_problem(cuda_device, K=K, d=d)
    cfg = IncrementalConfig(projection_dim=S, opt_itrs=T, i0=0.5, use_beta=use_beta)
    fused = multiclass.bundle(K)
    plain = fused._replace(fused_ll_projection=None, fused_beta_projection=None)
    smp = multiclass_laplace_sampler(K)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    z = lambda *shape: torch.randn(shape + (K * d,), generator=g, device=cuda_device)
    draws = FixedDraws([(z(S), None) for _ in range(itrs)], [(z(T, S), None)
                                                            for _ in range(itrs)])
    out = {}
    with world_of_one("nccl"):
        mesh = make_mesh(1, 1)
        gp = Groups.from_lists(groups, device=cuda_device)
        data, n = shard_data(Z, mesh)
        gid = shard_group_ids(group_ids_from_groups(gp, n), mesh, gp.n_groups)
        for name, model in (("kernel", fused), ("plain", plain)):
            b = make_sharded_group_builder(data, gid, n, gp, model, smp, cfg, mesh)
            gst = init_group_state(init_state(400, d + 1, beta=0.3, device=cuda_device,
                                              sampler_aux=torch.zeros(K * d,
                                                                      device=cuda_device)),
                                   len(groups))
            before = kernels.multiclass_projection.launches
            got = b.build(gst, itrs, draws)
            torch.cuda.synchronize()
            out[name] = (got, kernels.multiclass_projection.launches - before)
    assert out["kernel"][1] == itrs * (1 + T) and out["plain"][1] == 0
    (got, _), (ref, _) = out["kernel"], out["plain"]
    assert torch.equal(got.selected, ref.selected)
    assert int(got.core.m) == int(ref.core.m) > 0
    assert torch.equal(got.core.idcs, ref.core.idcs)
    err = float((got.core.wts - ref.core.wts).abs().max())
    assert err <= 5e-3 * float(ref.core.wts.abs().max()), err


@pytest.mark.cuda
def test_cuda_shard_group_ids_stay_on_the_card(cuda_device):
    """``shard_group_ids`` on a CUDA tensor: this rank's block on the
    mesh's device as int64 ids, whatever their dtype was."""
    from betacores_tpu_torch.parallel import make_mesh, shard_group_ids, world_of_one

    gid = torch.tensor([0, 0, 1, 2, 3], dtype=torch.int32, device=cuda_device)
    with world_of_one("nccl"):
        out = shard_group_ids(gid, make_mesh(1, 1), 3)
    assert out.device.type == "cuda" and out.dtype == torch.int64
    assert out.tolist() == [0, 0, 1, 2, 3]


@pytest.mark.cuda
def test_cuda_scatter_group_reduction_matches_onehot(cuda_device, monkeypatch):
    """The scatter reduction (index_put_ with accumulate) equals the
    one-hot product within float32 summation error, and rounds the same in
    every call."""
    from betacores_tpu_torch import multiclass, multiclass_laplace_sampler
    from betacores_tpu_torch.coresets import IncrementalConfig, make_group_incremental_builder
    from betacores_tpu_torch.coresets import groups as groups_mod
    from betacores_tpu_torch.ops.projection import Groups

    Z, groups = _group_problem(cuda_device, N=1 << 16, per=512)
    gp = Groups.from_lists(groups, device=cuda_device)
    cfg = IncrementalConfig(projection_dim=100, opt_itrs=2)
    make = lambda: make_group_incremental_builder(Z, gp, multiclass.bundle(3),
                                                  multiclass_laplace_sampler(3), cfg)
    onehot = make()
    monkeypatch.setattr(groups_mod, "ONEHOT_MAX_BYTES", 0)
    scatter = make()
    assert onehot.onehot is not None and scatter.onehot is None
    vecs = torch.randn((Z.shape[0], 100), generator=torch.Generator(device=cuda_device)
                       .manual_seed(0), device=cuda_device)
    a, b1, b2 = onehot.group_reduce(vecs), scatter.group_reduce(vecs), scatter.group_reduce(vecs)
    ref = torch.zeros((len(groups) + 1, 100), dtype=torch.float64, device=cuda_device)
    ref.index_add_(0, scatter.gid, vecs.double())
    torch.cuda.synchronize()
    assert torch.equal(b1, b2)
    for got in (a, b1):
        assert float((got.double() - ref[:len(groups)]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_contextual_group_build_equals_the_cpu(cuda_device):
    """A small contextual (neural-linear) group build, its refinement
    passes captured on the card, equals the same build on the CPU under
    the same draws and contexts, in float64: the same groups, indices and
    m, weights within 1e-9 of max|w|. The second context reaches the
    replayed graphs: the card's build under it equals the CPU's."""
    from betacores_tpu_torch import IncrementalConfig, init_state
    from betacores_tpu_torch.coresets import (FixedDraws, init_group_state,
                                              make_group_incremental_builder)
    from betacores_tpu_torch.models import neural_linear as tnl
    from betacores_tpu_torch.ops.projection import Groups

    rng = np.random.default_rng(5)
    N, D, F, S, T = 400, 4, 6, 16, 20
    X = rng.normal(size=(N, D))
    Z = torch.from_numpy(np.c_[X, X @ rng.normal(size=D) + 0.1 * rng.normal(size=N)])
    groups = [list(range(g * 10, g * 10 + 10)) for g in range(N // 10)]
    enc = tnl.Encoder(D, F)
    sf = tnl.neural_linear_sampler_factory(enc, torch.zeros(F, dtype=torch.float64),
                                           torch.eye(F, dtype=torch.float64), 0.5)
    mf = tnl.neural_linear_model_factory(enc, 0.5)
    cfg = IncrementalConfig(projection_dim=S, n_subsample_opt=50, opt_itrs=T, i0=0.1,
                            use_beta=True)
    ctxs = []
    for seed in (1, 2):
        e = tnl.Encoder(D, F)
        e.reset_parameters(torch.Generator().manual_seed(seed))
        e.norm0.running_mean.uniform_(-0.3, 0.3)
        ctxs.append({k: v.detach().clone() for k, v in e.state().items()})
    gen = torch.Generator().manual_seed(7)
    draws = FixedDraws([(torch.randn(S, F, dtype=torch.float64, generator=gen), None)
                        for _ in range(4)],
                       [(torch.randn(T, S, F, dtype=torch.float64, generator=gen),
                         torch.randint(0, N, (T, 50), generator=gen)) for _ in range(4)])
    out = {}
    for dev in ("cpu", cuda_device):
        b = make_group_incremental_builder(Z.to(dev), Groups.from_lists(groups, dev), mf, sf,
                                           cfg, contextual=True)
        gst = init_group_state(init_state(N, D + 1, beta=0.5, dtype=torch.float64,
                                          device=dev), len(groups))
        gst = b.build(gst, 2, draws, ctx=ctxs[0])
        out[dev] = b.build(gst, 2, draws, ctx=ctxs[1])
    if torch.cuda.is_available():
        assert out[cuda_device].core.wts.is_cuda
    got, want = out[cuda_device], out["cpu"]
    assert torch.equal(got.selected.cpu(), want.selected)
    assert torch.equal(got.core.idcs.cpu(), want.core.idcs) and int(want.core.m) >= 30
    scale = float(want.core.wts.abs().max())
    assert float((got.core.wts.cpu() - want.core.wts).abs().max()) <= 1e-9 * scale


def _mcmc_target(device, dtype):
    """A weighted logistic posterior (d = 4) and its chains' start."""
    from betacores_tpu_torch.models import logreg

    rng = np.random.default_rng(11)
    X = rng.normal(size=(60, 4))
    y = np.where(rng.uniform(size=60) < 1 / (1 + np.exp(-X.sum(1))), 1.0, -1.0)
    Z = torch.from_numpy(y[:, None] * X).to(device, dtype)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, 60)).to(device, dtype)
    return (lambda th: logreg.log_joint(Z, th, w)), torch.zeros(4, dtype=dtype, device=device)


def _mcmc_run(sampler, device, dtype, graph):
    """An HMC or NUTS run of 2 chains (40 + 40 iterations) under draws made
    on the CPU in float64."""
    from betacores_tpu_torch.inference import (HMCConfig, NUTSConfig, draw_hmc, draw_nuts,
                                               run_chains, run_chains_nuts)

    logprob, theta0 = _mcmc_target(device, dtype)
    if sampler == "hmc":
        cfg = HMCConfig(n_samples=40, n_warmup=40, L_max=16)
        draws = draw_hmc(torch.Generator().manual_seed(1), 2, 4, cfg, torch.float64)
        return run_chains(draws, logprob, theta0, 2, cfg, graph=graph)
    cfg = NUTSConfig(n_samples=40, n_warmup=40, max_treedepth=8)
    draws = draw_nuts(torch.Generator().manual_seed(1), 2, 4, cfg, torch.float64)
    return run_chains_nuts(draws, logprob, theta0, 2, cfg, graph=graph)


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_cuda_captured_mcmc_equals_eager(cuda_device, sampler):
    """Every iteration replayed as CUDA graphs (NUTS: its start, each
    doubling depth, its end) equals the same run dispatched eagerly, bit
    for bit, in float32."""
    got = _mcmc_run(sampler, cuda_device, torch.float32, True)
    want = _mcmc_run(sampler, cuda_device, torch.float32, False)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_cuda_mcmc_equals_the_cpu_in_float64(cuda_device, sampler):
    """The captured run on the card equals the CPU's under the same draws,
    in float64, to 1e-10 (the two sum in other orders)."""
    got = _mcmc_run(sampler, cuda_device, torch.float64, None)
    want = _mcmc_run(sampler, "cpu", torch.float64, None)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(), rtol=1e-10, atol=1e-10)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k].cpu().numpy(), want[1][k].numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=k)


@pytest.mark.cuda
def test_cuda_shf_training_equals_eager_and_the_cpu(cuda_device):
    """20 Adam steps of a flow, the step (a double backward) replayed as a
    CUDA graph: equal to the eager steps bit for bit, and in float64 to the
    CPU's within 1e-8."""
    from betacores_tpu_torch.inference import (SHFConfig, draw_shf, init_shf_params,
                                               make_shf_trainer)
    from betacores_tpu_torch.models import logreg

    rng = np.random.default_rng(12)
    X = rng.normal(size=(500, 3))
    y = np.where(rng.uniform(size=500) < 1 / (1 + np.exp(-X.sum(1))), 1.0, -1.0)
    Z = torch.from_numpy(y[:, None] * X)
    cfg = SHFConfig(n_blocks=2, n_leapfrog=3, n_mc=4, n_batch=32)
    draws = draw_shf(torch.Generator().manual_seed(2), 20, 500, 3, cfg, torch.float64)
    out = {}
    for dev, dtype, graph in ((cuda_device, torch.float32, True),
                              (cuda_device, torch.float32, False),
                              (cuda_device, torch.float64, None), ("cpu", torch.float64, None)):
        Zd = Z.to(dev, dtype)
        train = make_shf_trainer(Zd, logreg.log_joint, cfg, graph=graph)
        out[(str(dev), dtype, graph)] = train(draws, init_shf_params(Zd[:10], 3, 500, cfg), 20)
    torch.cuda.synchronize()
    a, b = out[("cuda", torch.float32, True)], out[("cuda", torch.float32, False)]
    assert torch.equal(a[1], b[1]) and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    c, d = out[("cuda", torch.float64, None)], out[("cpu", torch.float64, None)]
    for x, y in zip((c[1], *c[0]), (d[1], *d[0])):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-8, atol=1e-8)


@pytest.mark.cuda
def test_cuda_capture_survives_a_dead_graph_in_a_cycle(cuda_device):
    """A dead reference cycle that holds a captured graph is not collected
    while another graph is captured (destroying a graph then invalidates the
    capture): the body allocates enough containers to trigger the
    collector, and the capture and its replay still succeed."""
    from betacores_tpu_torch.utils import graphs

    x = torch.ones(4, device=cuda_device)
    cycle = [graphs.capture(lambda: x.add_(1.0))]
    cycle.append(cycle)
    del cycle

    def body():
        junk = [[] for _ in range(20000)]
        for a in junk:
            a.append(a)
        x.mul_(2.0)

    graphs.capture(body).replay()
    torch.cuda.synchronize()
    assert torch.equal(x.cpu(), torch.full((4,), 2.0))


@pytest.mark.cuda
def test_cuda_ops_launch_the_kernels_and_count(cuda_device):
    """K1's and K2's ``torch.library`` ops on card tensors launch the
    hand-written kernels (one count a call, the plain version's values
    within the kernels' tolerances), never the plain version."""
    ops_np, S = step_operands(np.random.default_rng(5))
    ops = _torch(ops_np, cuda_device)
    before = kernels.logreg_adam_step.launches
    got = torch.ops.betacores_torch.logreg_adam_step(*ops, S, True)
    assert kernels.logreg_adam_step.launches == before + 1
    want = kernels.logreg_adam_step_plain(*_torch(ops_np, "cpu"), S, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **TOL)
    z = torch.cat([torch.randn(9000, 10, device=cuda_device),
                   torch.randint(0, 5, (9000, 1), device=cuda_device).float()], 1)
    th = torch.randn(100, 50, device=cuda_device)
    beta = torch.tensor(0.3, device=cuda_device)
    before = kernels.multiclass_projection.launches
    got = torch.ops.betacores_torch.multiclass_projection(z, th, 5, 1.0, beta, True)
    assert kernels.multiclass_projection.launches == before + 1
    want = kernels.multiclass_projection_plain(z.cpu(), th.cpu(), 5, beta.cpu(), True)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5)


@pytest.mark.cuda
def test_cuda_exported_build_equals_the_live_build(cuda_device):
    """A logistic build exported on the card (K1's op at every step) and
    run from its artifact equals the live, captured build on the same
    stacked draws, and launches K1 once an Adam step."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.utils.export import (export_incremental_build, fixed_draws,
                                                  load_program, stack_draws)

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    _, _, Z = bc.gen_synthetic_logreg(gen, 20_000, d=10)
    cfg = bc.IncrementalConfig(projection_dim=100, n_subsample_select=1000,
                               n_subsample_opt=200, opt_itrs=20, i0=1.0, use_beta=True)
    b = bc.make_incremental_builder(Z, bc.logreg.bundle(), bc.logreg_laplace_sampler(), cfg)
    st0 = bc.init_state(128, 10, beta=0.1, device=cuda_device)
    draws = stack_draws(b, gen, st0, 3)
    call = load_program(export_incremental_build(b, Z, st0, draws_spec=draws),
                        device=cuda_device)
    before = kernels.logreg_adam_step.launches
    art = call(Z, draws, st0, torch.tensor(3, device=cuda_device))
    assert kernels.logreg_adam_step.launches == before + 3 * 20
    live = b.build(st0, 3, fixed_draws(draws))
    assert torch.equal(art.idcs, live.idcs) and int(art.m) == int(live.m)
    scale = max(1.0, float(live.wts.abs().max()))
    assert float((art.wts - live.wts).abs().max()) <= 5e-3 * scale


# an exported build asked for one selection more than its stacked draws hold,
# in a process of its own: the failed device assert poisons the card's
# context for the rest of the process
_PAST_THE_DRAWS = """
import torch
import betacores_tpu_torch as bc
from betacores_tpu_torch.utils.export import export_incremental_build, load_program, stack_draws

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
_, _, Z = bc.gen_synthetic_logreg(gen, 2000, d=10)
cfg = bc.IncrementalConfig(projection_dim=20, n_subsample_select=100, n_subsample_opt=50,
                           opt_itrs=5, i0=1.0, use_beta=True)
b = bc.make_incremental_builder(Z, bc.logreg.bundle(), bc.logreg_laplace_sampler(), cfg)
st0 = bc.init_state(16, 10, beta=0.1, device=dev)
draws = stack_draws(b, gen, st0, 2)
call = load_program(export_incremental_build(b, Z, st0, draws_spec=draws), device=dev)
st = call(Z, draws, st0, torch.tensor(2, device=dev))
print("WITHIN", int(st.m), flush=True)
st = call(Z, draws, st0, torch.tensor(3, device=dev))
torch.cuda.synchronize()
print("PAST", int(st.m), flush=True)
"""


@pytest.mark.cuda
def test_cuda_exported_build_past_its_draws_fails(cuda_device):
    """``itrs`` past the artifact's stacked selections fails on the card
    (utils/export.py: a device assert, raised at the next synchronisation
    as a CUDA error), after the same artifact served ``itrs`` within them."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _PAST_THE_DRAWS], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=root))
    assert "WITHIN 2" in r.stdout, r.stderr[-3000:]
    assert r.returncode != 0 and "PAST" not in r.stdout, r.stdout
    assert "device-side assert" in r.stderr or "itrs exceeds" in r.stderr, r.stderr[-3000:]
