"""The port's CUDA kernels against their plain versions, on the card: K1,
the fused refinement step (betacores_tpu_torch/csrc/logreg_adam_step.cu),
K2, the multiclass projection (csrc/multiclass_projection.cu), and K3, the
sharded step's shard-local partials (csrc/logreg_shard_partials.cu). This
file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Without a card its tests skip. Tolerances are the JAX package's own for
each kernel against its composition (tests/test_pallas_kernels.py): atol =
rtol = 2e-4 for K1, atol 2e-5 for K2, in float32; the kernels sum in
another order. K3's outputs are held within 2e-4 of each output's largest
magnitude (atol = rtol = 2e-4 relative to it), as chip_smoke.py holds them.

``step_operands`` builds the padded operands of tests/test_pallas_kernels.py
and is shared with test_torch_kernels.py; ``shard_operands`` those of K3,
shared with test_torch_shard_kernel.py.

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
