"""The port's incremental build (betacores_tpu_torch/coresets/incremental.py)
against the JAX build it replaces, under the JAX build's own random draws.

The two packages' random streams cannot match, so the JAX build's draws are
rebuilt from its key with the JAX package's own ``draw_noise`` and
``draw_subsample``, in the key-split recipe of
betacores_tpu/coresets/incremental.py (per iteration: fold_in, split into
select and optimize keys; select splits into (noise, subsample); optimize
splits into T step keys, each split into (noise, subsample)), and replayed
into the port through ``FixedDraws`` (with no select subsample under
full-candidate select). The JAX build routes its refinement through the
fused Pallas step (interpret mode on the CPU) and the port through its fused
step's plain version; or, for a model without the fused step, both through
the composed route. Both compute in float32; the problem is well
separated, so selections are compared exactly and weights within
5e-3 * max(1, max|w|), the tolerance of the JAX package's own fused-vs-XLA
test (tests/test_pallas_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu.ops.projection import draw_subsample as jdraw_subsample
from betacores_tpu_torch.coresets import (FixedDraws, IncrementalConfig,
                                         make_incremental_builder,
                                         state_from_numpy, state_to_numpy)
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg

torch.set_num_threads(1)

N, D, M, S = 1500, 5, 15, 40
N_SEL = N_OPT = 150
T, ITRS, BETA, I0 = 25, 8, 0.2, 0.5


@pytest.fixture(scope="module")
def problem():
    """The well-separated problem of tests/test_pallas_kernels.py."""
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return (y[:, None] * X).astype(np.float32)


def _cfgs(dedup, refit_every, fused_grad_step=True, **change):
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=I0, use_beta=True, dedup_select=dedup,
              refit_every=refit_every)
    kw.update(change)
    return JConfig(fused_grad_step=fused_grad_step, **kw), IncrementalConfig(**kw)


def _jax_state():
    return jinit_state(M, D, beta=BETA, sampler_aux=jnp.zeros(D, jnp.float32))


def replay_jax_draws(key, st, itrs, smp, n_rows, n_samples, n_steps, n_sel, n_opt,
                     n_cand=None):
    """The draws ``build(key, st, itrs)`` of the JAX package makes with
    sampler ``smp``, as torch tensors: per iteration (z_sel, idx_sel) and
    (z_all, idx_all). ``n_sel=None`` is full-candidate select, which draws
    no subsample (idx_sel None); ``n_opt=None`` is full-data refinement,
    whose steps draw their noise from the same keys (idx_all None).
    ``n_cand`` is the range of select's candidates when it is not the rows
    (the group builder draws groups)."""
    noise = lambda k: smp.draw_noise(k, n_samples, st.wts, st.pts, st.sampler_aux)
    sel, opt = [], []
    for i in range(itrs):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        k_samp, k_sub = jax.random.split(k1)
        sel.append((noise(k_samp), None if n_sel is None
                    else jdraw_subsample(k_sub, n_cand or n_rows, n_sel)[0]))
        pair = jax.vmap(jax.random.split)(jax.random.split(k2, n_steps))
        z_all = jax.vmap(noise)(pair[:, 0])
        idx_all = None if n_opt is None else jax.vmap(
            lambda k: jdraw_subsample(k, n_rows, n_opt)[0])(pair[:, 1])
        opt.append((z_all, idx_all))
    conv = lambda z, idx: (torch.from_numpy(np.array(z)), None if idx is None
                           else torch.from_numpy(np.array(idx)).long())
    return FixedDraws([conv(*p) for p in sel], [conv(*p) for p in opt])


def jax_draws(key, st, itrs, n_sel=N_SEL, n_opt=N_OPT):
    """The draws of the JAX logreg build of this file's configuration."""
    return replay_jax_draws(key, st, itrs, jsampler(), N, S, T, n_sel, n_opt)


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _assert_same_build(got, want):
    """Same m (at least 2), indices and rows; weights within
    5e-3 * max(1, max|w|); padding slots hold weight 0."""
    assert int(got["m"]) == int(want["m"]) >= 2
    np.testing.assert_array_equal(got["idcs"], want["idcs"])
    np.testing.assert_array_equal(got["pts"], want["pts"])
    w0 = want["wts"]
    np.testing.assert_allclose(got["wts"], w0, atol=5e-3 * max(1.0, np.abs(w0).max()))
    assert np.all(got["wts"][int(want["m"]):] == 0.0)


@pytest.mark.parametrize("refit_every", [1, 4])
@pytest.mark.parametrize("dedup", [False, True])
def test_build_matches_jax_under_replayed_draws(problem, dedup, refit_every):
    jcfg, tcfg = _cfgs(dedup, refit_every)
    key = jax.random.PRNGKey(3)
    st0 = _jax_state()
    jst = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(), jcfg).build(
        key, st0, ITRS)
    builder = make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                       logreg_laplace_sampler(), tcfg)
    tst = builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS,
                        jax_draws(key, st0, ITRS))
    _assert_same_build(state_to_numpy(tst), _np_state(jst))


@pytest.mark.parametrize("dedup", [False, True])
def test_select_step_alone_matches_jax(problem, dedup):
    """One select from a live coreset (the JAX state after three
    iterations): the port's ``select`` installs the same row in the same
    slot as the JAX build's next iteration."""
    jcfg, tcfg = _cfgs(dedup, 1)
    jb = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(), jcfg)
    st3 = jb.build(jax.random.PRNGKey(5), _jax_state(), 3)
    key = jax.random.PRNGKey(11)
    st4 = jb.build(key, st3, 1)
    builder = make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                       logreg_laplace_sampler(), tcfg)
    tst = builder.select(state_from_numpy(_np_state(st3), device="cpu"), jax_draws(key, st3, 1), 0)
    got, want = state_to_numpy(tst), _np_state(st4)
    assert int(got["m"]) == int(want["m"])
    np.testing.assert_array_equal(got["idcs"], want["idcs"])
    np.testing.assert_array_equal(got["pts"], want["pts"])
    # select leaves the weights alone and warm-starts the sampler
    np.testing.assert_array_equal(got["wts"], np.asarray(st3.wts))


def test_generator_draws_build_runs(problem):
    """The default draws provider drives a whole build on a torch.Generator:
    the coreset fills, weights are finite and non-negative."""
    _, tcfg = _cfgs(True, 1)
    builder = make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                       logreg_laplace_sampler(), tcfg)
    st = state_from_numpy(_np_state(_jax_state()), device="cpu")
    gen = torch.Generator().manual_seed(0)
    st, (wts, idcs, betas) = builder.build_trace(st, 4, builder.generator_draws(gen))
    assert int(st.m) == 4 and wts.shape == (4, M) and idcs.shape == (4, M)
    assert torch.isfinite(st.wts).all() and (st.wts >= 0).all() and st.wts.sum() > 0
    assert len(set(st.idcs[:4].tolist())) == 4


@pytest.mark.parametrize("dedup", [False, True])
def test_full_select_build_matches_jax(problem, dedup):
    """Full-candidate select (every row scored, no subsample) with the
    fused step's plain version, against the JAX build with its Pallas step
    (interpret mode)."""
    jcfg, tcfg = _cfgs(dedup, 1, n_subsample_select=None)
    key = jax.random.PRNGKey(7)
    st0 = _jax_state()
    jst = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(), jcfg).build(
        key, st0, ITRS)
    builder = make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                       logreg_laplace_sampler(), tcfg)
    tst = builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS,
                        jax_draws(key, st0, ITRS, n_sel=None))
    _assert_same_build(state_to_numpy(tst), _np_state(jst))


@pytest.mark.parametrize("refit_every", [1, 4])
def test_composed_route_matches_jax(problem, refit_every):
    """A model without the fused step refines through the composed route
    (utils/opt.py::nn_adam): against the JAX build's composed route
    (fused_grad_step=False) under the same draws."""
    jcfg, tcfg = _cfgs(False, refit_every, fused_grad_step=False)
    key = jax.random.PRNGKey(9)
    st0 = _jax_state()
    jst = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(), jcfg).build(
        key, st0, ITRS)
    plain = logreg.bundle()._replace(fused_ll_grad_step=None, fused_beta_grad_step=None)
    builder = make_incremental_builder(torch.from_numpy(problem), plain,
                                       logreg_laplace_sampler(), tcfg)
    assert builder.fstep is None
    tst = builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS,
                        jax_draws(key, st0, ITRS))
    _assert_same_build(state_to_numpy(tst), _np_state(jst))


@pytest.mark.parametrize("change", [
    dict(), dict(n_subsample_select=None, n_subsample_opt=None),
    dict(n_subsample_opt=None)])
def test_outside_the_slice_raises(problem, change):
    """learn_beta, which earlier slices left out, in each select and
    refinement mode (subsampled, full-data, subsampled select with
    full-data refinement): the joint (w, beta) refinement against the JAX
    build's under its replayed draws. The JAX learn_beta pass draws per
    step, splitting each of nn_adam's T step keys into (noise, subsample):
    the key walk that ``replay_jax_draws`` replays. The same selections and
    weights as the other build tests, and each iteration's beta within
    rel 1e-5 or 1e-6 absolute (float32: the error of a few hundred Adam
    updates of size ~1e-3 each). With i0 = 0.01 beta falls from 0.2 by about 0.04 a
    selection, so the early iterations hold it off its clamps."""
    jcfg, tcfg = _cfgs(False, 1, learn_beta=True, i0=0.01, **change)
    key = jax.random.PRNGKey(3)
    st0 = _jax_state()
    jst, (_, _, jbeta) = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(),
                                  jcfg).build_trace(key, st0, ITRS)
    builder = make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                       logreg_laplace_sampler(), tcfg)
    assert builder.fstep is None                    # never K1
    tst, (_, _, tbeta) = builder.build_trace(
        state_from_numpy(_np_state(st0), device="cpu"), ITRS,
        jax_draws(key, st0, ITRS, tcfg.n_subsample_select, tcfg.n_subsample_opt))
    _assert_same_build(state_to_numpy(tst), _np_state(jst))
    jbeta = np.asarray(jbeta)
    assert (jbeta[:3] > 0.05).all() and (np.diff(jbeta) <= 0).all()  # it moves
    np.testing.assert_allclose(tbeta.numpy(), jbeta, rtol=1e-5, atol=1e-6)


def test_data_weights_and_plain_model_raise(problem):
    """Data weights of the wrong shape raise. A model without the fused step
    takes the composed route, which needs the sampler's noise split: a
    sampler without ``from_noise`` (or, with lagged refits, without
    ``fit``) raises."""
    cfg = _cfgs(False, 1)[1]
    Z = torch.from_numpy(problem)
    with pytest.raises(ValueError):
        make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg,
                                 data_weights=torch.ones(N - 1))
    plain = logreg.bundle()._replace(fused_beta_grad_step=None)

    class NoSplit:
        draw_noise = staticmethod(logreg_laplace_sampler().draw_noise)

    with pytest.raises(NotImplementedError):
        make_incremental_builder(Z, plain, NoSplit(), cfg)

    class NoFit(NoSplit):
        from_noise = logreg_laplace_sampler().from_noise

    make_incremental_builder(Z, plain, NoFit(), cfg)
    with pytest.raises(NotImplementedError):
        make_incremental_builder(Z, plain, NoFit(), _cfgs(False, 4)[1])


@pytest.mark.parametrize("refit_every", [1, 4])
def test_diag_sampler_build_matches_jax(problem, refit_every):
    """The diagonal-Hessian Laplace sampler on the fused route: K1's plain
    version with L^-1 formed from the diagonal factor (the sampler has no
    fit_inv), against the JAX build through the Pallas step, under the
    JAX build's draws."""
    jcfg, tcfg = _cfgs(False, refit_every)
    key = jax.random.PRNGKey(13)
    st0 = _jax_state()
    jst = jbuilder(jnp.asarray(problem), jlogreg.bundle(), jsampler(diag=True), jcfg).build(
        key, st0, ITRS)
    builder = make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                       logreg_laplace_sampler(diag=True), tcfg)
    assert builder.fstep is not None
    draws = replay_jax_draws(key, st0, ITRS, jsampler(diag=True), N, S, T, N_SEL, N_OPT)
    tst = builder.build(state_from_numpy(_np_state(st0), device="cpu"), ITRS, draws)
    _assert_same_build(state_to_numpy(tst), _np_state(jst))
