"""Exported learn_beta builds, the cases and checks shared by
tests/test_torch_export_learn_beta.py and
tests/test_torch_export_learn_beta_mc.py (two files, so that the CPU run's
workers take them apart).

Each case is one learn_beta build, the port's and the JAX package's, on a
problem made from a numpy seed: the logistic build of
tests/test_torch_incremental.py (subsampled, and with full-data
refinement), the contaminated Gaussian of tests/test_torch_families_build.py
(float64) and the multiclass build of tests/test_torch_multiclass_build.py
(full select over 9000 rows, so every select projects through K2's op).
The port's build is exported once, its draws operand shaped for ITRS
selections, and held

- against the live builder on the same stacked draws, bit for bit, at two
  ``itrs`` (``check_artifact_equals_live``);
- fed the JAX build's draws (rebuilt from its key as
  ``replay_jax_draws`` rebuilds them), against the JAX artifact run on that
  key: the same selections, weights within 5e-3 * max(1, max|w|), and each
  iteration's beta (the port's artifact run at every size, the JAX
  build's trace) within rtol 1e-5, atol 1e-6, the bounds of
  tests/test_torch_incremental.py::test_outside_the_slice_raises
  (``check_against_jax``)."""

from __future__ import annotations

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import torch

import betacores_tpu_torch as bc
from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.utils import export_incremental_build as jexport
from betacores_tpu.utils import load_program as jload
from betacores_tpu_torch.coresets import (IncrementalConfig, make_incremental_builder,
                                         state_from_numpy)
from betacores_tpu_torch.utils import (BuildDraws, export_incremental_build, fixed_draws,
                                       load_program, stack_draws)
from test_torch_incremental import _assert_same_build, _np_state, replay_jax_draws


def _logistic(full_data: bool) -> dict:
    from test_torch_incremental import D, M, N_OPT, N_SEL, S, T, _cfgs
    from test_torch_incremental import problem as _problem

    from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
    from betacores_tpu.models import logreg as jlogreg

    change = dict(n_subsample_opt=None) if full_data else {}
    jcfg, tcfg = _cfgs(False, 1, learn_beta=True, i0=0.01, **change)
    return dict(X=_problem.__wrapped__(), jmodel=jlogreg.bundle(), jsmp=jsampler(), jcfg=jcfg,
                tmodel=bc.logreg.bundle(), tsmp=bc.logreg_laplace_sampler(), tcfg=tcfg,
                st0=jinit_state(M, D, beta=0.2, sampler_aux=jnp.zeros(D, jnp.float32)),
                itrs=8, S=S, T=T, n_sel=N_SEL, n_opt=None if full_data else N_OPT, key=3)


def _gaussian() -> dict:
    from betacores_tpu.inference.samplers import gaussian_conjugate_sampler as jgauss
    from betacores_tpu.models import gaussian as jg

    rng = np.random.default_rng(11)
    d = 4
    Sig = 3.0 * np.eye(d)
    X = np.vstack([rng.multivariate_normal(np.zeros(d), Sig, 600),
                   rng.normal(size=(60, d)) + 8.0])
    Siginv, logdet = np.linalg.inv(Sig), float(np.linalg.slogdet(Sig)[1])
    prior = (np.zeros(d), np.eye(d), Siginv)
    kw = dict(projection_dim=32, n_subsample_select=128, n_subsample_opt=64, opt_itrs=30,
              i0=0.02, use_beta=True, learn_beta=True)
    return dict(X=X, jmodel=jg.bundle(jnp.asarray(Siginv), logdet),
                jsmp=jgauss(*map(jnp.asarray, prior)), jcfg=JConfig(**kw),
                tmodel=bc.gaussian.bundle(torch.tensor(Siginv), logdet),
                tsmp=bc.gaussian_conjugate_sampler(*map(torch.tensor, prior)),
                tcfg=IncrementalConfig(**kw),
                st0=jinit_state(16, d, beta=0.3, sampler_aux=jnp.zeros(d), dtype=jnp.float64),
                itrs=6, S=32, T=30, n_sel=128, n_opt=64, key=5)


def _multiclass() -> dict:
    from test_torch_multiclass_build import BETA, D_X, K, M, N_OPT, S, T
    from test_torch_multiclass_build import problem as _problem

    from betacores_tpu.inference.samplers import multiclass_laplace_sampler as jsampler
    from betacores_tpu.models import multiclass as jmc

    kw = dict(projection_dim=S, n_subsample_select=None, n_subsample_opt=N_OPT, opt_itrs=T,
              i0=0.01, use_beta=True, learn_beta=True)
    return dict(X=_problem.__wrapped__(), jmodel=jmc.bundle(K), jsmp=jsampler(K),
                jcfg=JConfig(**kw), tmodel=bc.multiclass.bundle(K),
                tsmp=bc.multiclass_laplace_sampler(K), tcfg=IncrementalConfig(**kw),
                st0=jinit_state(M, D_X + 1, beta=BETA, sampler_aux=jnp.zeros(K * D_X,
                                                                            jnp.float32)),
                itrs=5, S=S, T=T, n_sel=None, n_opt=N_OPT, key=21)


CASES = {"logistic": lambda: _logistic(False), "logistic_full_data": lambda: _logistic(True),
         "gaussian": _gaussian, "multiclass": _multiclass}


@functools.cache
def exported(name: str) -> dict:
    """The case with the port's builder, its state, torch draws stacked for
    its ``itrs`` selections and the artifact exported on them."""
    c = CASES[name]()
    b = make_incremental_builder(torch.from_numpy(c["X"]), c["tmodel"], c["tsmp"], c["tcfg"])
    assert b.fstep is None and b.config.learn_beta            # never K1
    st0 = state_from_numpy(_np_state(c["st0"]), device="cpu")
    draws = stack_draws(b, torch.Generator().manual_seed(11), st0, c["itrs"])
    blob = export_incremental_build(b, b.data, st0, draws_spec=draws)
    return dict(c, builder=b, tst0=st0, draws=draws, blob=blob, art=load_program(blob))


def program_ops(blob: bytes) -> set:
    """The names of the custom ops an exported program calls, in its graph
    and in its loop bodies."""
    gm = torch.export.load(io.BytesIO(blob)).graph_module
    return {str(n.target) for m in gm.modules() if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if str(n.target).startswith("betacores_torch.")}


def check_artifact_equals_live(name: str) -> None:
    e = exported(name)
    b, st0, draws = e["builder"], e["tst0"], e["draws"]
    for itrs in (2, e["itrs"]):
        live = b.build(st0, itrs, fixed_draws(draws))
        art = e["art"](b.data, draws, st0, torch.tensor(itrs))
        for field in live._fields:
            assert torch.equal(getattr(art, field), getattr(live, field)), (name, itrs, field)
    assert int(art.m) >= 2 and float(art.beta) != float(st0.beta)


def _stacked(fd) -> BuildDraws:
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    return BuildDraws(stack([z for z, _ in fd.sel]), stack([i for _, i in fd.sel]),
                      stack([z for z, _ in fd.opt]), stack([i for _, i in fd.opt]))


def check_against_jax(name: str) -> None:
    e = exported(name)
    X, st0, itrs = e["X"], e["st0"], e["itrs"]
    key = jax.random.key(e["key"])
    jb = jbuilder(jnp.asarray(X), e["jmodel"], e["jsmp"], e["jcfg"])
    jart = jload(jexport(jb, jnp.asarray(X), st0))(jnp.asarray(X), key, st0,
                                                   jnp.asarray(itrs, jnp.int32))
    _, (_, _, jbeta) = jb.build_trace(key, st0, itrs)
    jbeta = np.asarray(jbeta)
    draws = _stacked(replay_jax_draws(key, st0, itrs, e["jsmp"], len(X), e["S"], e["T"],
                                      e["n_sel"], e["n_opt"]))
    data, tst0 = e["builder"].data, e["tst0"]
    got = e["art"](data, draws, tst0, torch.tensor(itrs))
    _assert_same_build({k: v.numpy() for k, v in got._asdict().items()}, _np_state(jart))
    tbeta = [float(e["art"](data, draws, tst0, torch.tensor(k)).beta) for k in range(1, itrs)]
    tbeta.append(float(got.beta))
    assert (jbeta[:2] > 0.05).all() and not np.allclose(jbeta, jbeta[0])   # it moves
    np.testing.assert_allclose(float(jart.beta), jbeta[-1], rtol=1e-6)
    np.testing.assert_allclose(tbeta, jbeta, rtol=1e-5, atol=1e-6)
