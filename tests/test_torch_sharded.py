"""The port's sharded build (betacores_tpu_torch/parallel/sharded.py) on gloo
process groups against the JAX sharded build on its virtual CPU mesh, under
the JAX build's own draws.

For each mesh shape (1, 1), (2, 2) and (4, 1), one world of spawned
processes (tests/torch_dist_worker.py) runs every case; N = 1501 is not
divisible by 2 or 4, so the last data shard is padded. The JAX build's
draws are rebuilt from its key in the key-split recipe of
betacores_tpu/parallel/sharded.py (per iteration: fold_in, split into
select and optimize keys; select splits into (noise, subsample), optimize
into T step keys, each split into (noise, subsample); every subsample key
is folded with the data-shard index), and each rank replays the noise and
its own shard's indices. The JAX build runs its refinement through the
shard-partials Pallas kernel K3 (``fused_grad_step=True``, interpret mode
on the CPU) and the port through K3's plain version; a weighted or
multiclass build takes the composed route in both. Both compute in
float32 on a well-separated problem, so the selections are compared
exactly and the weights within 5e-3 * max(1, max|w|), as in
test_torch_incremental.py. Every rank must return the same state.

A sampler without a noise split (the NIW family) takes the per-step-draw
route: the sampler is called at select and at every step, then the step's
shard-local subsample is drawn. Its draws depend on the weights, so no
JAX stream can be replayed through it: the route is held against the JAX
sharded build through a deterministic sampler without a noise split
(tests/test_parallel.py:345-371's NIW problem and configuration, the
JAX per-step keys' shard-local indices replayed in float64), and the real
NIW sampler on the port's own generator against the quality that test
asks of the JAX build, and, in a world of one given one generator for both
streams, against the single-device per-step-draw build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.incremental import IncrementalConfig as JConfig
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference.samplers import (gaussian_conjugate_sampler as jg_sampler,
                                              logreg_laplace_sampler as jlr_sampler,
                                              multiclass_laplace_sampler as jmc_sampler)
from betacores_tpu.models import gaussian as jgauss
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu.models import multiclass as jmc
from betacores_tpu.models import mvn as jmvn
from betacores_tpu.parallel import (make_mesh as jmake_mesh,
                                    make_sharded_incremental_builder as jsharded,
                                    shard_data as jshard_data,
                                    shard_weights as jshard_weights)
from oracle import models as om
from test_torch_incremental import _assert_same_build, _np_state
from torch_dist_worker import run_world

torch.set_num_threads(1)

N, D, M, S = 1501, 5, 15, 40
N_SEL = N_OPT = 150
T, ITRS, BETA, I0 = 20, 6, 0.2, 0.5
K, D_MC, N_MC = 3, 4, 601
N_ZERO = 1000          # the weighted case gives rows from here on weight 0
N_G, D_G = 601, 4      # the Gaussian case: tests/test_parallel.py's problem, one row longer


def _problem():
    """The well-separated problem of test_torch_incremental.py, one row
    longer."""
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return (y[:, None] * X).astype(np.float32)


def _mc_problem():
    rng = np.random.default_rng(17)
    Th = 2.0 * rng.normal(size=(K, D_MC))
    X = rng.normal(size=(N_MC, D_MC))
    y = np.argmax(X @ Th.T + rng.gumbel(size=(N_MC, K)), axis=1)
    return np.c_[X, y].astype(np.float32)


def _gauss_problem():
    """tests/test_parallel.py's known-covariance Gaussian (Sig = 3 I), in
    float32, with the model spec of the conjugate sampler's prior."""
    rng = np.random.default_rng(11)
    Sig = 3.0 * np.eye(D_G)
    X = rng.multivariate_normal(np.zeros(D_G), Sig, N_G).astype(np.float32)
    spec = ("gaussian", np.zeros(D_G, np.float32), np.eye(D_G, dtype=np.float32),
            np.linalg.inv(Sig).astype(np.float32), float(np.linalg.slogdet(Sig)[1]))
    return X, spec


def replay_sharded_draws(key, st, itrs, smp, n_true, n_data, n_samples, n_steps,
                         n_sel, n_opt):
    """The draws of the JAX sharded ``build(key, st, itrs)`` with sampler
    ``smp``, as numpy: per iteration (z_sel, [idx_sel of each data shard])
    and (z_all, [idx_all of each data shard]); None in place of a list
    where the build takes every local row."""
    rows_loc = -(-n_true // n_data)
    valid = [min(max(n_true - a * rows_loc, 0), rows_loc) for a in range(n_data)]
    n_sel = None if n_sel is None else max(1, n_sel // n_data)
    n_opt = None if n_opt is None else max(1, n_opt // n_data)
    noise = lambda k: smp.draw_noise(k, n_samples, st.wts, st.pts, st.sampler_aux)
    local = lambda k, n, a: jax.random.randint(jax.random.fold_in(k, a), (n,), 0,
                                               max(valid[a], 1))
    sel, opt = [], []
    for i in range(itrs):
        k_sel, k_opt = jax.random.split(jax.random.fold_in(key, i))
        k_samp, k_sub = jax.random.split(k_sel)
        sel.append((np.array(noise(k_samp)), None if n_sel is None else
                    [np.array(local(k_sub, n_sel, a)) for a in range(n_data)]))
        pair = jax.vmap(jax.random.split)(jax.random.split(k_opt, n_steps))
        z_all = np.array(jax.vmap(noise)(pair[:, 0]))
        opt.append((z_all, None if n_opt is None else
                    [np.array(jax.vmap(lambda k: local(k, n_opt, a))(pair[:, 1]))
                     for a in range(n_data)]))
    return sel, opt


def _cfg(**change):
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=I0, use_beta=True)
    kw.update(change)
    return kw


# name -> (model, config changes, weights?)
CASES = {
    "parity": ("logreg", dict(), False),
    "dedup_lagged": ("logreg", dict(dedup_select=True, refit_every=4), False),
    "full_select": ("logreg", dict(n_subsample_select=None), False),
    "full_data": ("logreg", dict(n_subsample_select=None, n_subsample_opt=None), False),
    "weighted": ("logreg", dict(), True),
    "multiclass": (("multiclass", K), dict(refit_every=2), False),
    # small steps keep beta off its clamps for the first iterations
    "learn_beta": ("logreg", dict(learn_beta=True, i0=0.01), False),
    # the conjugate sampler on the composed route, as tests/test_parallel.py
    "gaussian": ("gaussian", dict(use_beta=False, i0=1.0), False),
}


def _jax_case(name, n_data, n_samp, key):
    model, change, weighted = CASES[name]
    if model == "logreg":
        Z, bundle, smp = _problem(), jlogreg.bundle(), jlr_sampler()
        st0 = jinit_state(M, D, beta=BETA, sampler_aux=jnp.zeros(D, jnp.float32))
    elif model == "gaussian":
        Z, model = _gauss_problem()
        _, mu0, Sig0inv, Siginv, logdet = model
        bundle = jgauss.bundle(jnp.asarray(Siginv), logdet)
        smp = jg_sampler(jnp.asarray(mu0), jnp.asarray(Sig0inv), jnp.asarray(Siginv))
        st0 = jinit_state(M, D_G, beta=BETA, sampler_aux=jnp.zeros(D_G, jnp.float32))
    else:
        Z, bundle, smp = _mc_problem(), jmc.bundle(K), jmc_sampler(K)
        st0 = jinit_state(M, D_MC + 1, beta=BETA,
                          sampler_aux=jnp.zeros(K * D_MC, jnp.float32))
    u = None
    if weighted:
        u = np.ones(len(Z), np.float32)
        u[N_ZERO:] = 0.0
    cfg = _cfg(**change)
    mesh = jmake_mesh(n_data, n_samp)
    ds, n_true = jshard_data(jnp.asarray(Z), mesh)
    b = jsharded(ds, n_true, bundle, smp, JConfig(fused_grad_step=True, **cfg), mesh,
                 data_weights=None if u is None else jshard_weights(jnp.asarray(u), mesh))
    jst = b(key, st0, ITRS)
    sel, opt = replay_sharded_draws(key, st0, ITRS, smp, n_true, n_data, S, T,
                                    cfg["n_subsample_select"], cfg["n_subsample_opt"])
    job = dict(data=Z, weights=u, model=model, cfg=cfg, state=_np_state(st0),
               itrs=ITRS, sel=sel, opt=opt)
    return job, _np_state(jst)


# tests/test_parallel.py:345-371's NIW problem: d, clean rows, the
# configuration, buffer, beta and iterations
NIW_D, NIW_N = 3, 240
NIW_CFG = dict(projection_dim=16, n_subsample_select=64, n_subsample_opt=32, opt_itrs=15,
               i0=0.5, use_beta=True)
NIW_M, NIW_BETA, NIW_ITRS = 20, 0.5, 10
NIW_PRIOR = (np.zeros(NIW_D), 1.0, np.eye(NIW_D), NIW_D + 4.0)


def _niw_problem():
    rng = np.random.default_rng(4)
    return np.vstack([rng.normal(size=(NIW_N, NIW_D)) + 1.0,
                      rng.normal(size=(NIW_N // 10, NIW_D)) * 0.5 + 9.0])


class _NoNoise:
    """``replay_sharded_draws``'s noise for a sampler that draws none."""

    def draw_noise(self, key, n, wts, pts, aux):
        return jnp.zeros((n, 1))


def _jax_call_only_case(n_data, n_samp, **change):
    """The JAX sharded build of the NIW problem through a deterministic
    sampler without a noise split (S draws of the JAX NIW posterior of the
    clean rows), its per-step route's draws, and the port's job."""
    X = _niw_problem()
    td = NIW_D + NIW_D * NIW_D
    samples, _ = jmvn.mvn_niw_sampler(*(jnp.asarray(v) for v in NIW_PRIOR))(
        jax.random.PRNGKey(8), NIW_CFG["projection_dim"], jnp.ones(NIW_N),
        jnp.asarray(X[:NIW_N]), jnp.zeros(td))
    cfg = dict(NIW_CFG, **change)
    mesh = jmake_mesh(n_data, n_samp)
    ds, n_true = jshard_data(jnp.asarray(X), mesh)
    b = jsharded(ds, n_true, jmvn.bundle(NIW_D), lambda k, n, w, p, a: (samples[:n], a),
                 JConfig(**cfg), mesh)
    st0 = jinit_state(NIW_M, NIW_D, beta=NIW_BETA, sampler_aux=jnp.zeros(td), dtype=ds.dtype)
    key = jax.random.PRNGKey(1)
    jst = b(key, st0, NIW_ITRS)
    sel, opt = replay_sharded_draws(key, st0, NIW_ITRS, _NoNoise(), n_true, n_data,
                                    cfg["projection_dim"], cfg["opt_itrs"],
                                    cfg["n_subsample_select"], cfg["n_subsample_opt"])
    job = dict(data=X, model=("call_only", NIW_D, np.asarray(samples)), cfg=cfg,
               state=_np_state(st0), itrs=NIW_ITRS, sel=sel, opt=opt)
    return job, _np_state(jst)


@pytest.fixture(scope="module", params=[(1, 1), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request):
    """(JAX states, per-rank port results) of every case on one mesh."""
    n_data, n_samp = request.param
    key = jax.random.PRNGKey(3)
    jobs, want = {}, {}
    for name in CASES:
        jobs[name], want[name] = _jax_case(name, n_data, n_samp, key)
    # u = ones replays the parity case's draws
    jobs["ones"] = dict(jobs["parity"], weights=np.ones(N, np.float32))
    # the builder's own generator draws: the ranks must stay in step
    jobs["generator"] = dict(jobs["dedup_lagged"], generator_seed=5)
    jobs["trace"] = dict(jobs["parity"], trace=True)
    # the full-data case projects with the log-likelihood: under the
    # beta-likelihood every outlier row projects to one vector up to
    # rounding, and rounding would decide the argmax among them
    for name, change in (("niw_call_only", {}),
                         ("niw_call_only_full", dict(n_subsample_select=None,
                                                     n_subsample_opt=None, use_beta=False))):
        jobs[name], want[name] = _jax_call_only_case(n_data, n_samp, **change)
    niw = dict(jobs["niw_call_only"], model=("mvn", NIW_D, NIW_PRIOR), generator_seed=3)
    del niw["sel"], niw["opt"]
    jobs["niw"] = niw
    # one generator for both streams: a world of one draws the single-device stream
    jobs["niw_one_generator"] = dict(niw, one_generator=True)
    ranks = run_world(n_data, n_samp, jobs)
    return want, ranks, (n_data, n_samp)


def _every_rank(ranks, name):
    """The state every rank returned for ``name``; they must be equal."""
    states = [r["jobs"][name]["state"] for r in ranks]
    for st in states[1:]:
        for k, v in st.items():
            np.testing.assert_array_equal(v, states[0][k], err_msg=f"{name}: {k}")
    return states[0]


@pytest.mark.parametrize("name", ["parity", "dedup_lagged", "full_select"])
def test_fused_route_matches_jax(mesh_run, name):
    """K3's route (its plain version here) against the JAX build through
    the K3 Pallas kernel."""
    want, ranks, _ = mesh_run
    assert all(r["jobs"][name]["route"] == "fused" for r in ranks)
    _assert_same_build(_every_rank(ranks, name), want[name])


def test_full_data_build_matches_jax(mesh_run):
    """Full-data select and refinement: every local row, exact psums, the
    padding rows masked."""
    want, ranks, _ = mesh_run
    assert ranks[0]["jobs"]["full_data"]["route"] == "per_step"
    _assert_same_build(_every_rank(ranks, "full_data"), want["full_data"])


def test_weighted_build_matches_jax(mesh_run):
    """Weights with zeros: the composed route, as in the reference; no
    zero-weight row is selected."""
    want, ranks, _ = mesh_run
    got = _every_rank(ranks, "weighted")
    assert ranks[0]["jobs"]["weighted"]["route"] == "composed"
    _assert_same_build(got, want["weighted"])
    assert (got["idcs"][:int(got["m"])] < N_ZERO).all()


def test_unit_weights_select_as_unweighted(mesh_run):
    """u = ones takes the composed route and selects exactly what the
    unweighted (fused) build selects under the same draws."""
    _, ranks, _ = mesh_run
    ones, plain = _every_rank(ranks, "ones"), _every_rank(ranks, "parity")
    assert ranks[0]["jobs"]["ones"]["route"] == "composed"
    _assert_same_build(ones, plain)


def test_multiclass_composed_matches_jax(mesh_run):
    """A model without shard partials (multiclass) refines through the
    composed route with lagged refits."""
    want, ranks, _ = mesh_run
    assert ranks[0]["jobs"]["multiclass"]["route"] == "composed"
    _assert_same_build(_every_rank(ranks, "multiclass"), want["multiclass"])


def test_gaussian_build_matches_jax_and_reaches_its_quality(mesh_run):
    """The conjugate Gaussian sampler on the composed route: against the
    JAX sharded build under its draws, and to the quality
    tests/test_parallel.py asks of the JAX build: real rows, at least four
    kept points, and a reverse KL to the full posterior under 0.3 of the
    prior's."""
    want, ranks, _ = mesh_run
    assert ranks[0]["jobs"]["gaussian"]["route"] == "composed"
    got = _every_rank(ranks, "gaussian")
    _assert_same_build(got, want["gaussian"])
    X, (_, mu0, Sig0inv, Siginv, _) = _gauss_problem()
    X, mu0, Sig0inv, Siginv = (a.astype(np.float64) for a in (X, mu0, Sig0inv, Siginv))
    m, w, p = int(got["m"]), got["wts"].astype(np.float64), got["pts"].astype(np.float64)
    idcs = got["idcs"][:m]
    assert (idcs >= 0).all() and (idcs < N_G).all()
    np.testing.assert_array_equal(X[idcs].astype(np.float32), got["pts"][:m])
    mup, Sigp = om.gauss_weighted_post(mu0, Sig0inv, Siginv, X, np.ones(N_G))

    def rkl(w, p):
        muw, Sigw = om.gauss_weighted_post(mu0, Sig0inv, Siginv, np.atleast_2d(p),
                                           np.atleast_1d(w))
        return om.gaussian_KL(muw, Sigw, mup, np.linalg.inv(Sigp))

    keep = w > 0
    assert keep.sum() >= 4
    assert rkl(w[keep], p[keep]) < 0.3 * rkl(np.zeros(1), np.zeros((1, D_G)))


def test_generator_draws_keep_ranks_in_step(mesh_run):
    """The builder's own draws: the replicated stream is never advanced by
    a shard-local draw, so every rank ends with the same state; the build
    fills its selections with distinct real rows."""
    _, ranks, _ = mesh_run
    st = _every_rank(ranks, "generator")
    m = int(st["m"])
    assert m == ITRS and len(set(st["idcs"][:m].tolist())) == m
    assert (st["idcs"][:m] >= 0).all() and (st["idcs"][:m] < N).all()
    assert np.isfinite(st["wts"]).all() and (st["wts"] >= 0).all()


def test_build_trace_matches_build(mesh_run):
    """build_trace runs build's iterations: the same final state, and one
    (wts, idcs, beta) row per iteration whose last row is that state's."""
    _, ranks, _ = mesh_run
    st, plain = _every_rank(ranks, "trace"), _every_rank(ranks, "parity")
    for k, v in plain.items():
        np.testing.assert_array_equal(st[k], v, err_msg=k)
    for r in ranks:
        wts, idcs, beta = r["jobs"]["trace"]["trace"]
        assert wts.shape == idcs.shape == (ITRS, M) and beta.shape == (ITRS,)
        np.testing.assert_array_equal(wts[-1], st["wts"])
        np.testing.assert_array_equal(idcs[-1], st["idcs"])
        # one slot more filled per iteration at most, never fewer
        filled = (idcs >= 0).sum(axis=1)
        assert (np.diff(filled) >= 0).all() and (np.diff(filled) <= 1).all()


def test_collectives_per_step(mesh_run):
    """The fused route runs two psums per Adam step and the select three
    psums and one all_gather, on every mesh (an axis of size 1 included)."""
    _, ranks, _ = mesh_run
    calls = ranks[0]["jobs"]["parity"]["calls"]
    assert calls == {"psum": ITRS * (3 + 2 * T), "all_gather": ITRS}


def test_learn_beta_matches_jax_and_the_single_device_build(mesh_run):
    """The sharded joint (w, beta) refinement, replicated: against the JAX
    sharded learn_beta under its draws (beta within rel 1e-5 or 1e-6
    absolute, float32), with three psums per step (the centring of the
    rows, the buffer and its beta-gradient; the target; both inner
    products over S); and on the (1, 1) mesh, where the local indices are
    the global ones, against the single-device learn_beta build under the
    same draws."""
    from betacores_tpu_torch.coresets import (FixedDraws, IncrementalConfig,
                                             make_incremental_builder, state_from_numpy,
                                             state_to_numpy)
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.models import logreg

    want, ranks, shape = mesh_run
    assert all(r["jobs"]["learn_beta"]["route"] == "learn_beta" for r in ranks)
    got = _every_rank(ranks, "learn_beta")
    _assert_same_build(got, want["learn_beta"])
    assert 0.01 < float(want["learn_beta"]["beta"]) < BETA
    np.testing.assert_allclose(got["beta"], want["learn_beta"]["beta"], rtol=1e-5, atol=1e-6)
    calls = ranks[0]["jobs"]["learn_beta"]["calls"]
    assert calls == {"psum": ITRS * (3 + 3 * T), "all_gather": ITRS}
    if shape != (1, 1):
        return
    job = ranks[0]["jobs"]["learn_beta"]
    spec = _jax_case("learn_beta", 1, 1, jax.random.PRNGKey(3))[0]
    t = lambda a: None if a is None else torch.from_numpy(a[0] if isinstance(a, list) else a)
    draws = FixedDraws([(t(z), t(i)) for z, i in spec["sel"]],
                       [(t(z), t(i)) for z, i in spec["opt"]])
    b = make_incremental_builder(torch.from_numpy(spec["data"]), logreg.bundle(),
                                 logreg_laplace_sampler(), IncrementalConfig(**spec["cfg"]))
    single = state_to_numpy(b.build(state_from_numpy(spec["state"], device="cpu"), ITRS,
                                    draws))
    _assert_same_build(job["state"], single)
    np.testing.assert_allclose(job["state"]["beta"], single["beta"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["niw_call_only", "niw_call_only_full"])
def test_per_step_draw_route_matches_jax(mesh_run, name):
    """A sampler without a noise split, subsampled and full-data: the
    sampler called at select and at every step, the shard-local indices
    drawn after it, as the JAX per-step route under its keys (float64)."""
    want, ranks, _ = mesh_run
    assert all(r["jobs"][name]["route"] == "per_step" for r in ranks)
    _assert_same_build(_every_rank(ranks, name), want[name])


def test_niw_build_keeps_ranks_in_step_and_is_robust(mesh_run):
    """The NIW sampler on the port's own generator: every rank the same
    state, and (tests/test_parallel.py:368-371) the coreset's NIW
    posterior mean near the clean cluster, not the outliers."""
    from betacores_tpu_torch.models import mvn as tmvn

    _, ranks, _ = mesh_run
    st = _every_rank(ranks, "niw")
    m = int(st["m"])
    w, p = st["wts"], st["pts"]
    assert m > 0 and (w >= 0).all() and np.isfinite(w).all()
    keep = w > 0
    post = tmvn.weighted_post(*(torch.as_tensor(np.asarray(v)) for v in NIW_PRIOR),
                              torch.from_numpy(p[keep]), torch.from_numpy(w[keep]))
    assert np.linalg.norm(post.mu.numpy() - 1.0) < 2.0, post.mu


def test_niw_world_of_one_equals_the_single_device_build(mesh_run):
    """On the (1, 1) mesh, given one generator for the sampler's and the
    subsample's draws, the sharded NIW build draws what the single-device
    per-step-draw route draws (its generator's stream): the same idcs and
    m, weights within 1e-9 * max|w| (the sharded projections centre by a
    psum of row sums, the single-device ones by a mean)."""
    from betacores_tpu_torch.coresets import (IncrementalConfig, make_incremental_builder,
                                             state_from_numpy, state_to_numpy)
    from betacores_tpu_torch.models import mvn as tmvn

    _, ranks, shape = mesh_run
    if shape != (1, 1):
        assert not np.array_equal(_every_rank(ranks, "niw_one_generator")["wts"],
                                  np.zeros(NIW_M))
        return
    job = ranks[0]["jobs"]["niw_one_generator"]
    b = make_incremental_builder(torch.from_numpy(_niw_problem()), tmvn.bundle(NIW_D),
                                 tmvn.mvn_niw_sampler(*(torch.as_tensor(np.asarray(v))
                                                        for v in NIW_PRIOR)),
                                 IncrementalConfig(**NIW_CFG))
    st0 = _jax_call_only_case(1, 1)[0]["state"]
    single = state_to_numpy(b.build(state_from_numpy(st0, device="cpu"), NIW_ITRS,
                                    b.generator_draws(torch.Generator().manual_seed(3))))
    got = job["state"]
    assert int(got["m"]) == int(single["m"]) > 0
    np.testing.assert_array_equal(got["idcs"], single["idcs"])
    np.testing.assert_allclose(got["wts"], single["wts"], rtol=0,
                               atol=1e-9 * np.abs(single["wts"]).max())
