"""The port's incremental build (betacores_tpu_torch/coresets/incremental.py)
against the JAX build it replaces, under the JAX build's own random draws.

The two packages' random streams cannot match, so the JAX build's draws are
rebuilt from its key with the JAX package's own ``draw_noise`` and
``draw_subsample``, in the key-split recipe of
betacores_tpu/coresets/incremental.py (per iteration: fold_in, split into
select and optimize keys; select splits into (noise, subsample); optimize
splits into T step keys, each split into (noise, subsample)), and replayed
into the port through ``FixedDraws``. The JAX build routes its refinement
through the fused Pallas step (interpret mode on the CPU); the port through
its fused step's plain twin. Both compute in float32; the problem is well
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


def _cfgs(dedup, refit_every):
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=I0, use_beta=True, dedup_select=dedup,
              refit_every=refit_every)
    return JConfig(fused_grad_step=True, **kw), IncrementalConfig(**kw)


def _jax_state():
    return jinit_state(M, D, beta=BETA, sampler_aux=jnp.zeros(D, jnp.float32))


def jax_draws(key, st, itrs):
    """The draws ``build(key, st, itrs)`` of the JAX package makes, as
    torch tensors: per iteration (z_sel, idx_sel) and (z_all, idx_all)."""
    smp = jsampler()
    noise = lambda k: smp.draw_noise(k, S, st.wts, st.pts, st.sampler_aux)
    sel, opt = [], []
    for i in range(itrs):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        k_samp, k_sub = jax.random.split(k1)
        sel.append((noise(k_samp), jdraw_subsample(k_sub, N, N_SEL)[0]))
        pair = jax.vmap(jax.random.split)(jax.random.split(k2, T))
        z_all = jax.vmap(noise)(pair[:, 0])
        idx_all, _ = jax.vmap(lambda k: jdraw_subsample(k, N, N_OPT))(pair[:, 1])
        opt.append((z_all, idx_all))
    conv = lambda z, idx: (torch.from_numpy(np.array(z)),
                           torch.from_numpy(np.array(idx)).long())
    return FixedDraws([conv(*p) for p in sel], [conv(*p) for p in opt])


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


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
    tst = builder.build(state_from_numpy(_np_state(st0)), ITRS,
                        jax_draws(key, st0, ITRS))
    got, want = state_to_numpy(tst), _np_state(jst)
    assert int(got["m"]) == int(want["m"]) >= 2
    np.testing.assert_array_equal(got["idcs"], want["idcs"])
    np.testing.assert_array_equal(got["pts"], want["pts"])
    w0 = want["wts"]
    np.testing.assert_allclose(got["wts"], w0, atol=5e-3 * max(1.0, np.abs(w0).max()))
    assert np.all(got["wts"][int(want["m"]):] == 0.0)


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
    tst = builder.select(state_from_numpy(_np_state(st3)), jax_draws(key, st3, 1), 0)
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
    st = state_from_numpy(_np_state(_jax_state()))
    gen = torch.Generator().manual_seed(0)
    st, (wts, idcs, betas) = builder.build_trace(st, 4, builder.generator_draws(gen))
    assert int(st.m) == 4 and wts.shape == (4, M) and idcs.shape == (4, M)
    assert torch.isfinite(st.wts).all() and (st.wts >= 0).all() and st.wts.sum() > 0
    assert len(set(st.idcs[:4].tolist())) == 4


@pytest.mark.parametrize("change", [
    dict(learn_beta=True), dict(n_subsample_select=None), dict(n_subsample_opt=None)])
def test_outside_the_slice_raises(problem, change):
    kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
              opt_itrs=T, use_beta=True)
    kw.update(change)
    with pytest.raises(NotImplementedError):
        make_incremental_builder(torch.from_numpy(problem), logreg.bundle(),
                                 logreg_laplace_sampler(), IncrementalConfig(**kw))


def test_data_weights_and_plain_model_raise(problem):
    cfg = _cfgs(False, 1)[1]
    Z = torch.from_numpy(problem)
    with pytest.raises(NotImplementedError):
        make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg,
                                 data_weights=torch.ones(N))
    plain = logreg.bundle()._replace(fused_beta_grad_step=None)
    with pytest.raises(NotImplementedError):
        make_incremental_builder(Z, plain, logreg_laplace_sampler(), cfg)
