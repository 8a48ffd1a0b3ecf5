"""The port's pseudo-coresets (betacores_tpu_torch/coresets/bpsvi.py,
psvi.py, dpbpsvi.py and ``BatchPSVICoreset`` in api.py) against the JAX
package and the NumPy oracle, on the CPU, in float64.

- Under the JAX build's own draws (its initial rows, each step's posterior
  noise, subsample, Poisson batch and release noise, rebuilt from its key
  in the key-split recipe of the JAX module and replayed into the port):
  the same initial rows, and weights and points within 1e-6 of their
  largest magnitude. Both compute in float64, where the two stay within
  rounding of each other.
- BPSVI against oracle/coresets.py:299 (bpsvi_build_deterministic) at
  rtol 1e-6 (atol 1e-9 on the weights, 1e-8 on the points), as
  tests/test_coresets.py holds the JAX class.
- ``bpsvi_build_batch``: lane i equals the standalone build of lane i's
  draws with the tail masked (to 1e-12), and the JAX batch under the
  JAX lanes' draws.
- The RDP accountants equal the JAX functions to 1e-12 (relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betacores_tpu as jbc
import betacores_tpu_torch as bc
from betacores_tpu.coresets import bpsvi as jbpsvi
from betacores_tpu.coresets import dpbpsvi as jdp
from betacores_tpu.coresets.incremental import IncrementalConfig as JConfig
from betacores_tpu.coresets.psvi import make_psvi_builder as j_psvi
from betacores_tpu.coresets.state import init_state as j_init_state
from betacores_tpu.inference import fixed_sampler as j_fixed
from betacores_tpu.inference import gaussian_conjugate_sampler as j_gauss_sampler
from betacores_tpu.inference.samplers import logreg_laplace_sampler as j_laplace
from betacores_tpu.models import gaussian as j_gauss
from betacores_tpu.models import logreg as j_logreg
from betacores_tpu.ops.projection import draw_subsample as j_draw_subsample
from betacores_tpu.utils.prng import KeySequence as JKeySequence
from betacores_tpu_torch.coresets import (BPSVIConfig, BPSVIDraws, DPConfig, DPDraws,
                                         IncrementalConfig, bpsvi_build_batch,
                                         make_bpsvi_builder, make_dp_bpsvi_builder,
                                         make_psvi_builder, state_from_numpy)
from betacores_tpu_torch.coresets import dpbpsvi as tdp
from betacores_tpu_torch.inference import (fixed_sampler, gaussian_conjugate_sampler,
                                           logreg_laplace_sampler)
from betacores_tpu_torch.models import gaussian, logreg
from oracle import coresets as ocs
from oracle import models as om
from test_torch_incremental import replay_jax_draws

torch.set_num_threads(1)

N, D, S, T, N_OPT = 600, 4, 20, 30, 100
TOL = 1e-6


@pytest.fixture(scope="module")
def logistic():
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return y[:, None] * X


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


def jax_bpsvi_draws(key, sz, n_rows, noise, n_steps, n_opt, u=None):
    """The draws of the JAX BPSVI build ``build(key, sz, ...)``: its
    without-replacement init, then per step (split of split(k_opt, T)) the
    posterior noise and the subsample."""
    k_init, k_opt = jax.random.split(key)
    p = None if u is None else jnp.asarray(u) / jnp.asarray(u).sum()
    init = jax.random.choice(k_init, n_rows, (sz,), replace=False, p=p)
    pair = jax.vmap(jax.random.split)(jax.random.split(k_opt, n_steps))
    z_all = jax.vmap(noise)(pair[:, 0])
    idx = None if n_opt is None else jax.vmap(
        lambda k: j_draw_subsample(k, n_rows, n_opt)[0])(pair[:, 1])
    return BPSVIDraws(_t(init).long(), _t(z_all), None if idx is None else _t(idx).long())


def _laplace_noise(Z, sz):
    w, p, aux = jnp.zeros(sz), jnp.asarray(Z[:sz]), jnp.zeros(D)
    return lambda k: j_laplace().draw_noise(k, S, w, p, aux)


# --- BPSVI --------------------------------------------------------------------------


@pytest.mark.parametrize("n_opt", [N_OPT, None])
def test_bpsvi_matches_jax_under_jax_draws(logistic, n_opt):
    """The logistic Laplace sampler refitted at the moving pseudo-points at
    every step, on a subsample or on every row."""
    sz, key = 8, jax.random.PRNGKey(3)
    cfg = dict(projection_dim=S, n_subsample_opt=n_opt, opt_itrs=T, i0=0.5)
    jw, jp, ji = jbpsvi.make_bpsvi_builder(jnp.asarray(logistic), j_logreg.bundle(), j_laplace(),
                                           jbpsvi.BPSVIConfig(**cfg))(key, sz, jnp.zeros(D))
    builder = make_bpsvi_builder(torch.from_numpy(logistic), logreg.bundle(),
                                 logreg_laplace_sampler(), BPSVIConfig(**cfg))
    draws = jax_bpsvi_draws(key, sz, N, _laplace_noise(logistic, sz), T, n_opt)
    tw, tp, ti = builder.build(draws, sz, torch.zeros(D, dtype=torch.float64))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw)
    _close(tp, jp)
    assert (tw.numpy() > 0).any() and np.abs(tp.numpy() - logistic[ti.numpy()]).max() > 1e-6


def test_weighted_bpsvi_matches_jax_and_refuses_too_many_points(logistic):
    """data_weights: the init drawn in proportion to u (never a zero row),
    total mass sum(u), the target u-weighted; sz above the positive rows
    raises."""
    u = np.ones(N)
    u[: N // 2] = 0.0
    u[-50:] = 3.0
    sz, key = 6, jax.random.PRNGKey(5)
    cfg = dict(projection_dim=S, n_subsample_opt=N_OPT, opt_itrs=T, i0=0.5)
    jb = jbpsvi.make_bpsvi_builder(jnp.asarray(logistic), j_logreg.bundle(), j_laplace(),
                                   jbpsvi.BPSVIConfig(**cfg), data_weights=jnp.asarray(u))
    jw, jp, ji = jb(key, sz, jnp.zeros(D))
    builder = make_bpsvi_builder(torch.from_numpy(logistic), logreg.bundle(),
                                 logreg_laplace_sampler(), BPSVIConfig(**cfg),
                                 data_weights=torch.from_numpy(u))
    draws = jax_bpsvi_draws(key, sz, N, _laplace_noise(logistic, sz), T, N_OPT, u)
    tw, tp, ti = builder.build(draws, sz, torch.zeros(D, dtype=torch.float64))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (u[ti.numpy()] > 0).all()
    _close(tw, jw)
    _close(tp, jp)
    own = builder.build(torch.Generator().manual_seed(0), sz, torch.zeros(D,
                                                                          dtype=torch.float64))
    assert (u[own[2].numpy()] > 0).all()
    with pytest.raises(ValueError, match="positive data_weights"):
        builder.build(torch.Generator(), N // 2 + 1, torch.zeros(D, dtype=torch.float64))


def _gauss(rng, n=30, d=3, s=6):
    X = rng.normal(size=(n, d))
    samples = rng.normal(size=(s, d))
    Siginv = np.linalg.inv(2.0 * np.eye(d))
    logdet = float(np.linalg.slogdet(2.0 * np.eye(d))[1])
    return X, samples, Siginv, logdet


def test_bpsvi_matches_oracle():
    """oracle/coresets.py:299 (bpsvi_build_deterministic) through the
    object API, driven with the port build's own initial rows."""
    X, samples, Siginv, logdet = _gauss(np.random.default_rng(42))
    sz, opt_itrs = 5, 30
    sched = lambda i: 0.3 / (1.0 + i)
    model = gaussian.bundle(torch.from_numpy(Siginv), logdet)
    prj = bc.BlackBoxProjector(fixed_sampler(torch.from_numpy(samples)), samples.shape[0],
                               model=model)
    alg = bc.BatchPSVICoreset(X, prj, opt_itrs=opt_itrs, step_sched=lambda m: sched, seed=7,
                              device="cpu")
    alg.build(1, sz)
    w_got, p_got, i_got = alg.get()
    init_idcs = alg.state.idcs.numpy()[:sz]
    assert len(set(init_idcs.tolist())) == sz
    w_o, p_o = ocs.bpsvi_build_deterministic(
        X, init_idcs, opt_itrs, sched, lambda w, p: samples,
        lambda pts, s: om.gauss_log_likelihood(pts, s, Siginv, logdet),
        lambda pts, s: om.gauss_grad_x_log_likelihood(pts, s, Siginv))
    keep = w_o > 0
    np.testing.assert_allclose(w_got, w_o[keep], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(p_got, p_o[keep], rtol=1e-6, atol=1e-8)


def test_batch_lanes_equal_standalone_masked_builds_and_jax():
    """bpsvi_build_batch's contract (tests/test_coresets.py:320-338): lane
    i equals the standalone build of lane i's draws with slots >= sizes[i]
    masked; under the JAX lanes' draws the batch equals the JAX batch."""
    X, samples, _, _ = _gauss(np.random.default_rng(42))
    Siginv, logdet = np.eye(3), 0.0
    cfg = dict(projection_dim=6, opt_itrs=10, i0=0.3)
    model = gaussian.bundle(torch.from_numpy(Siginv), logdet)
    builder = make_bpsvi_builder(torch.from_numpy(X), model,
                                 fixed_sampler(torch.from_numpy(samples)), BPSVIConfig(**cfg))
    aux0 = torch.zeros(3, dtype=torch.float64)
    sizes = [2, 4]
    wts_b, pts_b, idcs_b = bpsvi_build_batch(builder, torch.Generator().manual_seed(5), sizes,
                                             4, aux0)
    gen = torch.Generator().manual_seed(5)
    lane_draws = [builder.draws(gen, 4, aux0) for _ in sizes]
    for lane, sz in enumerate(sizes):
        w1, p1, i1 = builder.build(lane_draws[lane], 4, aux0, torch.arange(4) < sz)
        np.testing.assert_allclose(wts_b[lane].numpy(), w1.numpy(), rtol=1e-12, atol=0)
        np.testing.assert_allclose(pts_b[lane].numpy(), p1.numpy(), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(idcs_b[lane].numpy(), i1.numpy())
        assert (w1.numpy()[sz:] == 0).all() and (w1.numpy()[:sz] > 0).any()
    # the JAX batch, each lane under its own key's draws
    jb = jbpsvi.make_bpsvi_builder(jnp.asarray(X), j_gauss.bundle(jnp.asarray(Siginv), logdet),
                                   j_fixed(jnp.asarray(samples)), jbpsvi.BPSVIConfig(**cfg))
    key = jax.random.key(5)
    jw, jp, _ = jbpsvi.bpsvi_build_batch(jb, key, sizes, 4, jnp.zeros(3))
    zeros = lambda k: jnp.zeros((6, 3))
    jdraws = [jax_bpsvi_draws(k, 4, X.shape[0], zeros, 10, None)
              for k in jax.random.split(key, len(sizes))]
    tw, tp, _ = bpsvi_build_batch(builder, jdraws, sizes, 4, aux0)
    _close(tw, jw, 1e-9)
    _close(tp, jp, 1e-9)


def test_batch_psvi_object_under_jax_draws_and_rebuilds(logistic):
    """BatchPSVICoreset fed the JAX object's key stream builds the JAX
    object's coreset at each size; every rebuild replaces the whole
    buffer (padding past sz); optimize() does nothing."""
    kw = dict(opt_itrs=T, n_subsample_opt=N_OPT, step_sched=lambda m: (lambda i: 0.5 / (1 + i)),
              seed=4)
    ja = jbc.BatchPSVICoreset(jnp.asarray(logistic),
                              jbc.BlackBoxProjector(j_laplace(), S, model=j_logreg.bundle()), **kw)
    ta = bc.BatchPSVICoreset(logistic, bc.BlackBoxProjector(logreg_laplace_sampler(), S,
                                                            model=logreg.bundle()),
                             device="cpu", **kw)
    keys = JKeySequence(4)
    ta._draws = lambda sz: jax_bpsvi_draws(keys(), sz, N, _laplace_noise(logistic, sz), T,
                                           N_OPT)
    for sz in (3, 6, 6):
        ja.build(1, sz)
        ta.build(1, sz)
        for got, want in zip(ta.get(), ja.get()):
            _close(got, want)
        assert int(ta.state.m) == sz and (ta.state.idcs.numpy()[sz:] == -1).all()
        assert (ta.state.wts.numpy()[sz:] == 0).all()
    before = ta.state
    ta.optimize()
    assert ta.state is before and ta.error() == 0.0


# --- PSVI ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sel,n_opt", [(150, N_OPT), (None, None)])
def test_psvi_matches_jax_under_jax_draws(logistic, n_sel, n_opt):
    """Select with the duplicate guard only, then the joint refinement of
    the buffer's weights and locations."""
    key, M, itrs = jax.random.PRNGKey(7), 6, 4
    kw = dict(projection_dim=S, n_subsample_select=n_sel, n_subsample_opt=n_opt,
              opt_itrs=T, i0=0.5)
    st0 = j_init_state(M, D, dtype=jnp.float64)
    jst = j_psvi(jnp.asarray(logistic), j_logreg.bundle(), j_laplace(), JConfig(**kw))(
        key, st0, itrs)
    builder = make_psvi_builder(torch.from_numpy(logistic), logreg.bundle(),
                                logreg_laplace_sampler(), IncrementalConfig(**kw))
    draws = replay_jax_draws(key, st0, itrs, j_laplace(), N, S, T, n_sel, n_opt)
    tst = builder.build(state_from_numpy({k: np.asarray(v) for k, v in st0._asdict().items()},
                                         device="cpu"), itrs, draws)
    assert int(tst.m) == int(jst.m) >= 2
    np.testing.assert_array_equal(tst.idcs.numpy(), np.asarray(jst.idcs))
    _close(tst.wts, jst.wts)
    _close(tst.pts, jst.pts)
    m = int(tst.m)
    assert np.abs(tst.pts.numpy()[:m] - logistic[tst.idcs.numpy()[:m]]).max() > 1e-6


def test_pseudo_sparsevi_object_under_jax_draws_and_refusals(logistic):
    kw = dict(n_subsample_select=150, n_subsample_opt=N_OPT, opt_itrs=T, seed=2, max_size=8,
              step_sched=lambda i: 0.5 / (1.0 + i))
    ja = jbc.coresets.PseudoSparseVICoreset(
        jnp.asarray(logistic), jbc.BlackBoxProjector(j_laplace(), S, model=j_logreg.bundle()),
        **kw)
    ta = bc.PseudoSparseVICoreset(logistic, bc.BlackBoxProjector(
        logreg_laplace_sampler(), S, model=logreg.bundle()), device="cpu", **kw)
    keys = JKeySequence(2)
    jst = j_init_state(8, D, dtype=jnp.float64)
    ta._draws = lambda itrs: replay_jax_draws(keys(), jst, itrs, j_laplace(), N, S, T, 150,
                                              N_OPT)
    ja.build(3, 3)
    ta.build(3, 3)
    assert ta.size() == ja.size() >= 2
    for got, want in zip(ta.get(), ja.get()):
        _close(got, want)
    with pytest.raises(ValueError, match="size overrun"):
        ta.build(8, 8)
    with pytest.raises(ValueError, match="KL-projection only"):
        make_psvi_builder(torch.from_numpy(logistic), logreg.bundle(), logreg_laplace_sampler(),
                          IncrementalConfig(projection_dim=S, use_beta=True))


# --- DP-BPSVI -----------------------------------------------------------------------


def _dp_problem():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((400, 3)) + 1.0
    return X


def jax_dp_draws(key, sz, X, jsmp, n_steps, poisson, q, n_opt):
    """The draws of the JAX DP-BPSVI build: the init release's and the
    scatter's normals from split(k_init), then per step (a 3-way split of
    split(k_opt, T)) the posterior noise, the batch and the release noise."""
    n_rows, d = X.shape
    k_init, k_opt = jax.random.split(key)
    k1, k2 = jax.random.split(k_init)
    e1 = jax.random.normal(k1, (d,), dtype=jnp.float64)
    e2 = jax.random.normal(k2, (sz, d), dtype=jnp.float64)
    trip = jax.vmap(lambda k: jax.random.split(k, 3))(jax.random.split(k_opt, n_steps))
    w, p = jnp.ones(sz), jnp.asarray(X[:sz])
    z = jax.vmap(lambda k: jsmp.draw_noise(k, 16, w, p, jnp.zeros(d)))(trip[:, 0])
    if poisson:
        batch = jax.vmap(lambda k: jax.random.bernoulli(k, q, (n_rows,)))(trip[:, 1])
    else:
        batch = jax.vmap(lambda k: jax.random.permutation(k, n_rows)[:n_opt])(trip[:, 1])
    noise = jax.vmap(lambda k: jax.random.normal(k, (16,), dtype=jnp.float64))(trip[:, 2])
    return DPDraws(_t(e1), _t(e2), _t(z), _t(batch) if poisson else _t(batch).long(), _t(noise))


@pytest.mark.parametrize("sampling", ["poisson", "swr"])
def test_dp_bpsvi_matches_jax_under_jax_draws(sampling):
    """The clipped, noised and rescaled step sums and the private init, on
    the Gaussian model with its exact posterior (examples/dp_bpsvi.py's
    setting at N = 400, M = 6, S = 16, 40 steps on 100-row batches)."""
    X = _dp_problem()
    n, d = X.shape
    sz, steps, n_opt, key = 6, 40, 100, jax.random.PRNGKey(9)
    dp = dict(clip_norm=1.0, noise_multiplier=1.0, init_clip_norm=10.0, init_spread=1.0,
              sampling=sampling)
    cfg = dict(projection_dim=16, n_subsample_opt=n_opt, opt_itrs=steps, i0=1.0)
    jsmp = j_gauss_sampler(jnp.zeros(d), jnp.eye(d), jnp.eye(d))
    jw, jp = jdp.make_dp_bpsvi_builder(jnp.asarray(X), j_gauss.bundle(jnp.eye(d), 0.0), jsmp,
                                       jbpsvi.BPSVIConfig(**cfg), jdp.DPConfig(**dp))(
        key, sz, jnp.zeros(d))
    builder = make_dp_bpsvi_builder(
        torch.from_numpy(X), gaussian.bundle(torch.eye(d, dtype=torch.float64), 0.0),
        gaussian_conjugate_sampler(torch.zeros(d, dtype=torch.float64),
                                   torch.eye(d, dtype=torch.float64),
                                   torch.eye(d, dtype=torch.float64)),
        BPSVIConfig(**cfg), DPConfig(**dp))
    draws = jax_dp_draws(key, sz, X, jsmp, steps, sampling == "poisson", n_opt / n, n_opt)
    tw, tp = builder.build(draws, sz, torch.zeros(d, dtype=torch.float64))
    _close(tw, jw)
    _close(tp, jp)
    # no pseudo-point is a data row
    dists = np.min(np.linalg.norm(tp.numpy()[:, None] - X[None], axis=-1), axis=1)
    assert (dists > 1e-6).all()


def test_dp_poisson_slots_and_private_init():
    """The Poisson batch in its fixed cap-row buffer (first cap included
    rows in order, the rest of the buffer masked), and the init release's
    noise std noise_multiplier * 2 * init_clip_norm / N."""
    X = _dp_problem()
    n, d = X.shape
    builder = make_dp_bpsvi_builder(
        torch.from_numpy(X), gaussian.bundle(torch.eye(d, dtype=torch.float64), 0.0),
        gaussian_conjugate_sampler(torch.zeros(d, dtype=torch.float64),
                                   torch.eye(d, dtype=torch.float64),
                                   torch.eye(d, dtype=torch.float64)),
        BPSVIConfig(projection_dim=8, n_subsample_opt=100, opt_itrs=3),
        DPConfig(noise_multiplier=2.0, init_clip_norm=0.5, init_spread=0.0))
    assert builder.cap == tdp.poisson_batch_cap(n, 0.25) < n
    e1 = torch.ones(d, dtype=torch.float64)
    got = builder.private_init(e1, torch.zeros((2, d), dtype=torch.float64)).numpy()
    clipped = X * np.minimum(1.0, 0.5 / np.linalg.norm(X, axis=1, keepdims=True))
    want = clipped.sum(0) / n + 2.0 * 2.0 * 0.5 / n
    np.testing.assert_allclose(got, np.broadcast_to(want, (2, d)), rtol=1e-12)
    gen = torch.Generator().manual_seed(0)
    draws = builder.draws(gen, 2, torch.zeros(d, dtype=torch.float64))
    assert draws.batch_all.dtype == torch.bool and draws.batch_all.shape == (3, n)
    w, p = builder.build(draws, 2, torch.zeros(d, dtype=torch.float64))
    assert np.isfinite(w.numpy()).all() and np.isfinite(p.numpy()).all()


def test_accountants_equal_jax():
    for steps, nm, delta in ((30, 1.0, 1e-5), (300, 2.5, 1e-6)):
        assert tdp.gaussian_rdp_epsilon(steps, nm, delta) == pytest.approx(
            jdp.gaussian_rdp_epsilon(steps, nm, delta), rel=1e-12)
    for q, nm in ((0.1, 1.0), (0.04, 0.7), (1.0, 2.0), (0.0, 1.0)):
        np.testing.assert_allclose(tdp.sgm_rdp(q, nm), jdp.sgm_rdp(q, nm), rtol=1e-12)
    for n, q in ((5000, 0.1), (200, 0.32), (10**6, 2e-4)):
        cap = tdp.poisson_batch_cap(n, q)
        assert cap == jdp.poisson_batch_cap(n, q)
        assert tdp.poisson_overflow_p(n, q, cap) == jdp.poisson_overflow_p(n, q, cap)
        assert tdp.subsampled_gaussian_epsilon(300, q, 1.0, 1e-5, n=n, cap=cap) == \
            pytest.approx(jdp.subsampled_gaussian_epsilon(300, q, 1.0, 1e-5, n=n, cap=cap),
                          rel=1e-12)
    with pytest.raises(ValueError):
        tdp.subsampled_gaussian_epsilon(300, 0.1, 1.0, 1e-5, n=5000, cap=500)
    with pytest.raises(ValueError):
        DPConfig(sampling="other")


@pytest.mark.parametrize("sampling", ["poisson", "swr"])
def test_dp_object_epsilon_and_build(sampling):
    """DiffPrivBatchPSVICoreset: its epsilon equals the JAX object's; a
    build on its own stream gives finite pseudo-points off the data rows."""
    X = _dp_problem()
    d = X.shape[1]
    kw = dict(opt_itrs=30, n_subsample_opt=64, noise_multiplier=1.0, seed=0, sampling=sampling)
    jprj = jbc.BlackBoxProjector(j_gauss_sampler(jnp.zeros(d), jnp.eye(d), jnp.eye(d)), 8,
                                 model=j_gauss.bundle(jnp.eye(d), 0.0))
    tprj = bc.BlackBoxProjector(gaussian_conjugate_sampler(
        torch.zeros(d, dtype=torch.float64), torch.eye(d, dtype=torch.float64),
        torch.eye(d, dtype=torch.float64)), 8,
        model=gaussian.bundle(torch.eye(d, dtype=torch.float64), 0.0))
    ja = jbc.DiffPrivBatchPSVICoreset(jnp.asarray(X), jprj, **kw)
    ta = bc.DiffPrivBatchPSVICoreset(X, tprj, device="cpu", **kw)
    assert ta.epsilon() == pytest.approx(ja.epsilon(), rel=1e-12)
    assert ta.epsilon(1e-6) == pytest.approx(ja.epsilon(1e-6), rel=1e-12)
    ta.build(1, 6)
    w, p = ta.get()
    assert len(w) >= 1 and (w >= 0).all() and np.isfinite(p).all() and ta.size() == len(w)
    dists = np.min(np.linalg.norm(p[:, None] - X[None], axis=-1), axis=1)
    assert (dists > 1e-6).all()
