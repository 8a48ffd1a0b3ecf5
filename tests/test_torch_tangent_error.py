"""``make_tangent_error`` / ``builder.error`` and ``build_with_data`` of the
port (betacores_tpu_torch/coresets/incremental.py) against the JAX package.

The error is ||scaling * sum_n u_n v_n - w . corevecs|| / S under one
posterior draw and one subsample. The JAX function's own draws are rebuilt
from its key (split into the sampler's key and the subsample's, as
betacores_tpu/coresets/incremental.py::make_tangent_error does) and
injected into the port: rtol 1e-5 in float64 and 2e-4 in float32 (the
projections' float32 sums run in another order)."""

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
from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                         make_incremental_builder, state_from_numpy)
from betacores_tpu_torch.coresets.incremental import make_tangent_error
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from test_torch_incremental import _np_state

torch.set_num_threads(1)

N, D, M, S, N_OPT, T = 800, 5, 12, 40, 120, 10


def _problem(dtype):
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    u = rng.uniform(0.0, 2.0, size=N)
    u[::7] = 0.0
    return (y[:, None] * X).astype(dtype), u.astype(dtype)


def _kw(**change):
    kw = dict(projection_dim=S, n_subsample_select=150, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=0.5, use_beta=True)
    kw.update(change)
    return kw


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("n_opt", [N_OPT, None], ids=["subsampled", "full"])
@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-5), (np.float32, 2e-4)],
                         ids=["float64", "float32"])
def test_tangent_error_matches_jax(dtype, rtol, n_opt, weighted):
    Z, u = _problem(dtype)
    u = u if weighted else None
    kw = _kw(n_subsample_opt=n_opt)
    jb = jbuilder(jnp.asarray(Z), jlogreg.bundle(), jsampler(), JConfig(**kw),
                  data_weights=None if u is None else jnp.asarray(u))
    st0 = jinit_state(M, D, beta=0.2, dtype=jnp.dtype(dtype))
    jst = jb.build(jax.random.PRNGKey(1), st0, 4)           # a live coreset
    key = jax.random.PRNGKey(9)
    want = float(jb.error(key, jst))
    k_samp, k_sub = jax.random.split(key)
    z = jsampler().draw_noise(k_samp, S, jst.wts, jst.pts, jst.sampler_aux)
    idx = None if n_opt is None else torch.from_numpy(
        np.array(jdraw_subsample(k_sub, N, n_opt)[0])).long()
    error = make_tangent_error(torch.from_numpy(Z), logreg.bundle(), logreg_laplace_sampler(),
                               IncrementalConfig(**kw),
                               None if u is None else torch.from_numpy(u))
    tst = state_from_numpy(_np_state(jst), device="cpu")
    got = error(tst, (torch.from_numpy(np.array(z)), idx))
    assert got.dtype == torch.from_numpy(Z).dtype and got.shape == ()
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=rtol)


def _builder(Z, u=None, **change):
    return make_incremental_builder(torch.from_numpy(Z), logreg.bundle(),
                                    logreg_laplace_sampler(), IncrementalConfig(**_kw(**change)),
                                    data_weights=None if u is None else torch.from_numpy(u))


def test_builder_error_draws_from_a_generator():
    """``builder.error`` with a generator: the same seed gives the same
    value, the injected draws of that stream give it too, and refinement
    lowers the error of a freshly selected state under shared draws. The
    draws must carry a subsample exactly when the refinement has one."""
    Z, _ = _problem(np.float32)
    b = _builder(Z)
    st = b.build(init_state(M, D, beta=0.2, device="cpu"), 3,
                 b.generator_draws(torch.Generator().manual_seed(0)))
    e1 = b.error(st, torch.Generator().manual_seed(5))
    assert torch.equal(e1, b.error(st, torch.Generator().manual_seed(5)))
    gen = torch.Generator().manual_seed(5)
    z = b.sampler.draw_noise(gen, S, st.wts, st.pts, st.sampler_aux)
    idx = torch.randint(0, N, (N_OPT,), generator=gen)
    assert torch.equal(e1, b.error(st, (z, idx)))
    draws = b.generator_draws(torch.Generator().manual_seed(3))
    picked = b.select(st, draws, 0)
    refined = b.optimize(picked, draws, 0)
    assert float(b.error(refined, (z, idx))) < float(b.error(picked, (z, idx)))
    with pytest.raises(ValueError, match="subsample"):
        b.error(st, (z, None))
    with pytest.raises(ValueError, match="subsample"):
        _builder(Z, n_subsample_opt=None).error(st, (z, idx))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_build_with_data_equals_build(weighted):
    """A builder made over one dataset builds another of the same shape
    exactly as that dataset's own builder does, and is itself again
    afterwards."""
    Z, u = _problem(np.float32)
    u = u if weighted else None
    Z2 = np.ascontiguousarray(Z[::-1] * np.float32(1.1))
    u2 = None if u is None else np.ascontiguousarray(u[::-1])
    st0 = init_state(M, D, beta=0.2, device="cpu")
    own = _builder(Z2, u2)
    want = own.build(st0, 3, own.generator_draws(torch.Generator().manual_seed(4)))
    other = _builder(Z, u)
    mine = other.build(st0, 3, other.generator_draws(torch.Generator().manual_seed(4)))
    got = other.build_with_data(torch.from_numpy(Z2),
                                None if u2 is None else torch.from_numpy(u2), st0, 3,
                                other.generator_draws(torch.Generator().manual_seed(4)))
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
    assert not torch.equal(got.idcs, mine.idcs)
    again = other.build(st0, 3, other.generator_draws(torch.Generator().manual_seed(4)))
    assert torch.equal(again.wts, mine.wts) and torch.equal(again.idcs, mine.idcs)


@pytest.mark.parametrize("bad", ["rows", "columns", "weights"])
def test_build_with_data_raises_on_another_shape(bad):
    Z, u = _problem(np.float32)
    b = _builder(Z)
    data = {"rows": Z[:-1], "columns": Z[:, :-1]}.get(bad, Z)
    weights = u[:-1] if bad == "weights" else None
    with pytest.raises(ValueError, match="build_with_data"):
        b.build_with_data(torch.from_numpy(np.ascontiguousarray(data)),
                          None if weights is None else torch.from_numpy(weights),
                          init_state(M, D, beta=0.2, device="cpu"), 1,
                          b.generator_draws(torch.Generator().manual_seed(0)))
