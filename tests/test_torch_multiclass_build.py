"""The port's multiclass beta-Cores build with full-candidate select against
the JAX build, under the JAX build's own draws (the replay recipe of
test_torch_incremental.py).

The configuration is examples/multiclass.py's cut to a small size: K = 3
classes, d = 4 features, 20 % label flips, beta = 0.3, N = 9000 rows, so
that every select projects more than FUSED_MIN_ROWS rows and the port
routes it to the K2 projection (on the CPU its plain version; the JAX
build, off the TPU, the XLA composition). The refinement takes the
composed route (utils/opt.py::nn_adam) on 100-row subsamples. Both compute
in float32; selections are compared exactly and weights within
5e-3 * max(1, max|w|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.inference.samplers import multiclass_laplace_sampler as jsampler
from betacores_tpu.models import multiclass as jmc
from betacores_tpu_torch.coresets import (IncrementalConfig, make_incremental_builder,
                                         state_from_numpy, state_to_numpy)
from betacores_tpu_torch.inference import multiclass_laplace_sampler
from betacores_tpu_torch.models import multiclass
from betacores_tpu_torch.ops import kernels
from test_torch_incremental import replay_jax_draws

torch.set_num_threads(1)

N, K, D_X, S, M = 9000, 3, 4, 32, 10
N_OPT, T, ITRS, BETA, I0, F_RATE = 100, 20, 5, 0.3, 0.5, 0.2


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(17)
    Th = 2.0 * rng.normal(size=(K, D_X))
    X = rng.normal(size=(N, D_X))
    y = np.argmax(X @ Th.T + rng.gumbel(size=(N, K)), axis=1)
    bad = rng.choice(N, int(N * F_RATE), replace=False)
    y[bad] = (y[bad] + rng.integers(1, K, size=len(bad))) % K
    return np.c_[X, y].astype(np.float32)


@pytest.mark.parametrize("dedup, refit_every", [(False, 1), (True, 4)])
def test_full_select_multiclass_build_matches_jax(problem, dedup, refit_every):
    assert kernels.maybe_fused(N) and not kernels.maybe_fused(N_OPT + M)
    kw = dict(projection_dim=S, n_subsample_select=None, n_subsample_opt=N_OPT,
              opt_itrs=T, i0=I0, use_beta=True, dedup_select=dedup,
              refit_every=refit_every)
    key = jax.random.PRNGKey(21)
    st0 = jinit_state(M, D_X + 1, beta=BETA, sampler_aux=jnp.zeros(K * D_X, jnp.float32))
    jst = jbuilder(jnp.asarray(problem), jmc.bundle(K), jsampler(K), JConfig(**kw)).build(
        key, st0, ITRS)
    builder = make_incremental_builder(torch.from_numpy(problem), multiclass.bundle(K),
                                       multiclass_laplace_sampler(K), IncrementalConfig(**kw))
    assert builder.fstep is None and builder.n_sel is None
    draws = replay_jax_draws(key, st0, ITRS, jsampler(K), N, S, T, None, N_OPT)
    st = state_from_numpy({k: np.asarray(v) for k, v in st0._asdict().items()},
                          device="cpu")
    got = state_to_numpy(builder.build(st, ITRS, draws))
    want = {k: np.asarray(v) for k, v in jst._asdict().items()}
    m = int(want["m"])
    assert int(got["m"]) == m >= 3
    np.testing.assert_array_equal(got["idcs"], want["idcs"])
    np.testing.assert_array_equal(got["pts"], want["pts"])
    w0 = want["wts"]
    np.testing.assert_allclose(got["wts"], w0, atol=5e-3 * max(1.0, np.abs(w0).max()))
    assert np.all(got["wts"][m:] == 0.0) and np.all(got["idcs"][m:] == -1)
    np.testing.assert_allclose(got["sampler_aux"], want["sampler_aux"], atol=5e-3)
