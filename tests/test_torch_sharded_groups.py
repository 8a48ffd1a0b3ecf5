"""The port's sharded group build (betacores_tpu_torch/parallel/groups.py)
on gloo process groups against the JAX sharded group build on its virtual
CPU mesh of the same shape, under the JAX build's own draws.

For each mesh shape (1, 1), (2, 2) and (4, 1), one world of spawned
processes (tests/torch_dist_worker.py, ``kind="group"``) runs every case of
tests/test_parallel.py's sharded group tests at their sizes (the
known-covariance Gaussian, float64): the full-candidate exact-gradient
build (:289-330), the subsampled build (:379-391), the weighted build with
zero-mass groups (:507-556), dedup select (:688-706) and the trace
(:374-400). The JAX draws are rebuilt from its key in the key-split recipe
of betacores_tpu/parallel/groups.py (per iteration: fold_in, split into
select and optimize keys; select splits into (noise, candidates), the
candidates drawn over the G groups and replicated; optimize into T step
keys, each split into (noise, subsample), the subsample key folded with
the data-shard index). Each build must select the same groups, points and
m, with weights within 5e-3 * max(1, max|w|) of the JAX weights (the bar
every ported build is held to; in float64, where the JAX and the port's
subsampled group builds do not amplify rounding), and every rank must
return the same state.

A multiclass case holds the ``samp = 1`` route (each block centred
locally through the model's fused projection, K2's plain version here on
9000 local rows) against the ``samp = 2`` route (uncentred projections
centred by one psum over ``samp``) on the same data and draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.groups import (group_ids_from_groups as jgids,
                                           init_group_state as jinit_group_state)
from betacores_tpu.coresets.incremental import IncrementalConfig as JConfig
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference.samplers import gaussian_conjugate_sampler as jg_sampler
from betacores_tpu.models import gaussian as jgauss
from betacores_tpu.ops.projection import Groups as JGroups
from betacores_tpu.parallel import (make_mesh as jmake_mesh,
                                    make_sharded_group_builder as jgroup_builder,
                                    shard_data as jshard_data, shard_group_ids as jshard_gids,
                                    shard_weights as jshard_weights)
from test_torch_incremental import _assert_same_build, _np_state
from test_torch_sharded import replay_sharded_draws
from torch_dist_worker import run_world

torch.set_num_threads(1)

D = 4


def _problem(n):
    """tests/test_parallel.py's known-covariance Gaussian (Sig = 3 I), its
    first n rows, with the model spec of its conjugate sampler."""
    rng = np.random.default_rng(11)
    Sig = 3.0 * np.eye(D)
    X = rng.multivariate_normal(np.zeros(D), Sig, 600)[:n]
    Siginv = np.linalg.inv(Sig)
    spec = ("gaussian", np.zeros(D), np.eye(D), Siginv, float(np.linalg.slogdet(Sig)[1]))
    return X, spec


def _sized_groups():
    """TestShardedGroups._setup's ten groups of sizes 3 to 25 over 120 rows."""
    groups, i = [], 0
    for s in [5, 12, 3, 20, 10, 10, 25, 15, 8, 12]:
        groups.append(list(range(i, i + s)))
        i += s
    return groups


def _weights(groups):
    """Groups 0-3 and half of group 4 at weight 0 (test_parallel.py:534-537)."""
    u = np.ones(120)
    for g in range(4):
        u[groups[g]] = 0.0
    u[groups[4][:5]] = 0.0
    return u


TENS = [list(range(i, i + 10)) for i in range(0, 120, 10)]
SUB = dict(projection_dim=16, n_subsample_select=12, n_subsample_opt=64, i0=0.5)
# name -> (rows, groups, config, buffer, iterations, key, weights?, trace?)
CASES = {
    "full": (120, _sized_groups(), dict(projection_dim=16, opt_itrs=15, i0=0.5), 80, 5, 3,
             False, False),
    "subsampled": (120, _sized_groups(), dict(SUB, opt_itrs=15), 80, 6, 1, False, False),
    "weighted": (120, TENS, dict(SUB, opt_itrs=10), 60, 5, 3, True, False),
    "dedup": (600, [list(range(i, min(i + 25, 600))) for i in range(0, 600, 25)],
              dict(projection_dim=16, opt_itrs=10, i0=1.0, dedup_select=True), 128, 4, 3,
              False, False),
    "trace": (120, TENS, dict(SUB, opt_itrs=10), 60, 5, 5, False, True),
}


def replay_group_draws(key, st, itrs, smp, n_true, n_data, cfg, n_groups):
    """The draws of the JAX sharded group ``build(key, st, itrs)``: the
    point builder's (test_torch_sharded.py), with select's candidates drawn
    over the groups and replicated."""
    n_sel = cfg.get("n_subsample_select")
    sel, opt = replay_sharded_draws(key, st, itrs, smp, n_true, n_data, cfg["projection_dim"],
                                    cfg["opt_itrs"], None, cfg.get("n_subsample_opt"))
    if n_sel is not None:
        for i in range(itrs):
            k_sel, _ = jax.random.split(jax.random.fold_in(key, i))
            _, k_sub = jax.random.split(k_sel)
            sel[i] = (sel[i][0], np.array(jax.random.randint(k_sub, (n_sel,), 0, n_groups)))
    return sel, opt


def _jax_case(name, n_data, n_samp):
    n, groups, cfg, cap, itrs, seed, weighted, trace = CASES[name]
    X, spec = _problem(n)
    _, mu0, Sig0inv, Siginv, logdet = spec
    smp = jg_sampler(jnp.asarray(mu0), jnp.asarray(Sig0inv), jnp.asarray(Siginv))
    gp = JGroups.from_lists(groups)
    mesh = jmake_mesh(n_data, n_samp)
    ds, n_true = jshard_data(jnp.asarray(X), mesh)
    gid = jshard_gids(jgids(gp, n), mesh, gp.n_groups)
    u = _weights(groups) if weighted else None
    b = jgroup_builder(ds, gid, n_true, gp, jgauss.bundle(jnp.asarray(Siginv), logdet), smp,
                       JConfig(**cfg), mesh,
                       data_weights=None if u is None else jshard_weights(jnp.asarray(u), mesh))
    st0 = jinit_state(cap, D, dtype=jnp.float64)
    key = jax.random.key(seed)
    gst0 = jinit_group_state(st0, gp.n_groups)
    want = {}
    if trace:
        gst, (W, I, SEL) = b.trace(key, gst0, itrs)
        want["trace"] = [np.asarray(x) for x in (W, I, SEL)]
    else:
        gst = b(key, gst0, itrs)
    want.update(state=_np_state(gst.core), selected=np.asarray(gst.selected))
    sel, opt = replay_group_draws(key, st0, itrs, smp, n_true, n_data, cfg, gp.n_groups)
    job = dict(kind="group", data=X, groups=groups, weights=u, model=spec, cfg=cfg,
               state=_np_state(st0), itrs=itrs, sel=sel, opt=opt, trace=trace)
    return job, want


@pytest.fixture(scope="module", params=[(1, 1), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, tmp_path_factory):
    """(JAX results, per-rank port results, mesh shape) of every case."""
    n_data, n_samp = request.param
    jobs, want = {}, {}
    for name in CASES:
        jobs[name], want[name] = _jax_case(name, n_data, n_samp)
    # u = ones replays the subsampled case's draws
    jobs["ones"] = dict(jobs["subsampled"], weights=np.ones(120))
    # the builder's own generator draws: the ranks must stay in step
    jobs["generator"] = dict(jobs["weighted"], generator_seed=7)
    ranks = run_world(n_data, n_samp, jobs, tmp_path_factory.mktemp(f"groups{n_data}x{n_samp}"))
    return want, ranks, (n_data, n_samp)


def _every_rank(ranks, name):
    """The (state, selected) every rank returned for ``name``; they must be
    equal."""
    outs = [r["jobs"][name] for r in ranks]
    for o in outs[1:]:
        for k, v in o["state"].items():
            np.testing.assert_array_equal(v, outs[0]["state"][k], err_msg=f"{name}: {k}")
        np.testing.assert_array_equal(o["selected"], outs[0]["selected"])
    return outs[0]["state"], outs[0]["selected"]


def _whole_groups(st, selected, groups):
    """The coreset holds exactly the selected groups' rows, in whole groups."""
    m = int(st["m"])
    sel = np.flatnonzero(selected)
    assert m == sum(len(groups[g]) for g in sel)
    assert set(st["idcs"][:m].tolist()) == set(np.concatenate([groups[g] for g in sel]).tolist())


@pytest.mark.parametrize("name", ["full", "subsampled", "dedup"])
def test_group_build_matches_jax(mesh_run, name):
    """Exact-gradient (full-candidate), subsampled (candidates with
    replacement, the stratified per-shard refinement subsample) and dedup
    builds: the JAX groups, points and weights; whole groups, whose
    gathered rows are the data's."""
    want, ranks, _ = mesh_run
    st, selected = _every_rank(ranks, name)
    assert ranks[0]["jobs"][name]["route"] == "group"
    np.testing.assert_array_equal(selected, want[name]["selected"])
    _assert_same_build(st, want[name]["state"])
    X, _ = _problem(CASES[name][0])
    m = int(st["m"])
    np.testing.assert_array_equal(st["pts"][:m], X[st["idcs"][:m]])
    _whole_groups(st, selected, CASES[name][1])


def test_weighted_group_build_matches_jax(mesh_run):
    """Zero-mass groups are never selected and u = 0 members never enter
    the coreset (the stable partition of the gathered block), as in JAX."""
    want, ranks, _ = mesh_run
    st, selected = _every_rank(ranks, "weighted")
    np.testing.assert_array_equal(selected, want["weighted"]["selected"])
    _assert_same_build(st, want["weighted"]["state"])
    sel = np.flatnonzero(selected)
    assert len(sel) >= 1 and (sel >= 4).all()
    u = _weights(TENS)
    m = int(st["m"])
    assert (u[st["idcs"][:m]] > 0).all()
    X, _ = _problem(120)
    np.testing.assert_array_equal(st["pts"][:m], X[st["idcs"][:m]])


def test_unit_weights_build_as_unweighted(mesh_run):
    """u = ones selects and weighs as the unweighted build under the same
    draws (weights to 1e-9 relative: u v_n and the masked sums round
    alike but for the order of the weighted sums)."""
    _, ranks, _ = mesh_run
    ones, ones_sel = _every_rank(ranks, "ones")
    plain, plain_sel = _every_rank(ranks, "subsampled")
    np.testing.assert_array_equal(ones_sel, plain_sel)
    np.testing.assert_array_equal(ones["idcs"], plain["idcs"])
    np.testing.assert_allclose(ones["wts"], plain["wts"], rtol=1e-9, atol=1e-12)


def test_group_trace_matches_jax_and_build(mesh_run):
    """build_trace: one (wts, idcs, selected) row per iteration, each
    against the JAX trace's; its last row is the built state."""
    want, ranks, _ = mesh_run
    st, selected = _every_rank(ranks, "trace")
    W, I, SEL = ranks[0]["jobs"]["trace"]["trace"]
    jW, jI, jSEL = want["trace"]["trace"]
    assert W.shape == jW.shape and SEL.shape == jSEL.shape
    np.testing.assert_array_equal(I, jI)
    np.testing.assert_array_equal(SEL, jSEL)
    np.testing.assert_allclose(W, jW, atol=5e-3 * max(1.0, np.abs(jW).max()))
    np.testing.assert_array_equal(W[-1], st["wts"])
    np.testing.assert_array_equal(SEL[-1], selected)


def test_generator_draws_keep_ranks_in_step(mesh_run):
    """The builder's own draws (replicated noise and candidates, per-shard
    subsamples): every rank ends with the same state, of whole groups with
    positive mass."""
    _, ranks, _ = mesh_run
    st, selected = _every_rank(ranks, "generator")
    assert int(st["m"]) > 0 and np.isfinite(st["wts"]).all() and (st["wts"] >= 0).all()
    assert (np.flatnonzero(selected) >= 4).all()


def test_collectives_per_iteration(mesh_run):
    """A select runs three psums (the group sums over ``data``, every inner
    product over S, the member gather) and a step two (the target, the
    gradient's inner product), plus on a ``samp`` axis above 1 one more
    each block projection (their centring); a weighted build two more at
    make time."""
    _, ranks, (n_data, n_samp) = mesh_run
    _, _, cfg, _, itrs, _, _, _ = CASES["full"]
    centre = 1 if n_samp > 1 else 0
    want = itrs * (3 + centre + cfg["opt_itrs"] * (2 + centre))
    assert ranks[0]["jobs"]["full"]["calls"] == {"psum": want}


@pytest.fixture(scope="module")
def mc_routes(tmp_path_factory):
    """One multiclass group build (K = 3, 9000 rows in 90 groups, float64,
    full-candidate select and exact refinement) under one set of draws on
    a (1, 1) world, where each block goes to the fused projection, and on a
    (1, 2) world, where the blocks are centred by a psum over ``samp``."""
    from betacores_tpu_torch.coresets import (IncrementalConfig, group_ids_from_groups,
                                             init_group_state, init_state, state_to_numpy)
    from betacores_tpu_torch.data import flip_labels, gen_synthetic_multiclass
    from betacores_tpu_torch.inference import multiclass_laplace_sampler
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.parallel import ShardedGroupDraws

    K, d, n, S, T, itrs = 3, 4, 9000, 16, 10, 3
    gen = torch.Generator().manual_seed(2)
    _, _, Z = gen_synthetic_multiclass(gen, n, d=d, n_classes=K, dtype=torch.float64)
    Z, _ = flip_labels(gen, Z, K, 0.2)
    groups = [list(range(g * 100, (g + 1) * 100)) for g in range(n // 100)]
    st0 = init_state(300, d + 1, beta=0.3, sampler_aux=torch.zeros(K * d, dtype=torch.float64),
                     dtype=torch.float64, device="cpu")
    cfg = dict(projection_dim=S, opt_itrs=T, i0=0.5, use_beta=True)
    rep = ShardedGroupDraws(torch.Generator().manual_seed(4), torch.Generator(),
                            multiclass_laplace_sampler(K), n, None, None, T, S, len(groups))
    sel = [tuple(x.numpy() if x is not None else None for x in rep.select(i, st0))
           for i in range(itrs)]
    opt = [tuple(x.numpy() if x is not None else None for x in rep.optimize(i, st0))
           for i in range(itrs)]
    job = dict(kind="group", data=Z.numpy(), groups=groups, model=("multiclass", K), cfg=cfg,
               state=state_to_numpy(st0), itrs=itrs, sel=sel, opt=opt, count_fused=True)
    return {shape: run_world(*shape, {"mc": job},
                             tmp_path_factory.mktemp(f"mc{shape[0]}x{shape[1]}"))
            for shape in [(1, 1), (1, 2)]}, itrs, T


def test_multiclass_fused_route_equals_the_samp_psum_route(mc_routes):
    """The samp = 1 route projects each 9000-row block through the fused
    projection (select and every step; the 300-slot buffer stays below
    FUSED_MIN_ROWS), the samp = 2 route never; both compute the
    reference's centred projection, so they select the same groups and
    points, and the weights agree to 1e-5 * max|w| in float64 (the two
    centre in another order, and Adam, dividing each coordinate's step by
    its own gradient's magnitude, carries that rounding into the weights
    of coordinates whose gradient is near 0)."""
    runs, itrs, T = mc_routes
    one, two = runs[(1, 1)][0]["jobs"]["mc"], runs[(1, 2)]
    assert one["fused"] == itrs * (1 + T)
    assert all(r["jobs"]["mc"]["fused"] == 0 for r in two)
    st2, sel2 = _every_rank(two, "mc")
    np.testing.assert_array_equal(one["selected"], sel2)
    assert int(one["state"]["m"]) == int(st2["m"]) > 0
    np.testing.assert_array_equal(one["state"]["idcs"], st2["idcs"])
    np.testing.assert_array_equal(one["state"]["pts"], st2["pts"])
    w = one["state"]["wts"]
    np.testing.assert_allclose(st2["wts"], w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_contracts(tmp_path):
    """learn_beta, lagged refits, a mesh that is not one and misshapen
    group ids or weights raise, as the reference's builder refuses them."""
    import datetime

    import torch.distributed as dist

    import betacores_tpu_torch as bc
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.parallel import (make_mesh, make_sharded_group_builder,
                                              shard_data, shard_group_ids)

    X = torch.zeros((10, D), dtype=torch.float64)
    gp = Groups.from_lists([[0, 1], [2, 3, 4]], "cpu")
    model, smp = bc.logreg.bundle(), bc.logreg_laplace_sampler()
    with pytest.raises(ValueError, match="mesh must have axes"):
        make_sharded_group_builder(X, torch.zeros(10), 10, gp, model, smp,
                                   bc.IncrementalConfig(), None)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(1, 1)
        data, n = shard_data(X, mesh)
        gid = shard_group_ids(torch.tensor([0, 0, 1, 1, 1] + [2] * 5), mesh, 2)
        assert gid.dtype == torch.int64 and gid.tolist() == [0, 0, 1, 1, 1] + [2] * 5
        make = lambda cfg, **kw: make_sharded_group_builder(data, kw.pop("gid", gid), n, gp,
                                                            model, smp, cfg, mesh, **kw)
        with pytest.raises(NotImplementedError, match="learn_beta"):
            make(bc.IncrementalConfig(use_beta=True, learn_beta=True))
        with pytest.raises(NotImplementedError, match="refit_every"):
            make(bc.IncrementalConfig(refit_every=2))
        with pytest.raises(ValueError, match="gid_local"):
            make(bc.IncrementalConfig(), gid=gid[:3])
        with pytest.raises(ValueError, match="data_weights"):
            make(bc.IncrementalConfig(), data_weights=torch.ones(3))
        assert make(bc.IncrementalConfig()).route == "group"
    finally:
        dist.destroy_process_group()
