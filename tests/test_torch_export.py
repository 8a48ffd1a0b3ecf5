"""Exported builds (betacores_tpu_torch/utils/export.py) and the two kernel
ops they hold (ops/kernels.py: ``betacores_torch::logreg_adam_step``, K1,
and ``betacores_torch::multiclass_projection``, K2), on the CPU.

The port's counterpart of tests/test_aux.py's export tests: one artifact
serves several ``itrs`` and equals the live builder bit for bit (the
composed route of the Gaussian family, its full-data refinement, K1's fused
route, with lagged refits, the weighted logistic build's composed route
with lagged refits of the diagonal sampler, K2's full-candidate multiclass
select, a weighted builder, which exports the weighted program by default
and never selects a zero-weight row), through a file, and in a fresh
process that imports no model module.
The live build replays the stacked draws through ``FixedDraws``, and
equals the build from the generator they were drawn from. The port's
artifact fed the JAX build's draws selects the JAX artifact's points, its
weights within 5e-3 * max(1, max|w|), the parity bound of every build test
(tests/test_torch_incremental.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import betacores_tpu_torch as bc
from betacores_tpu_torch.coresets import IncrementalConfig, init_state, make_incremental_builder
from betacores_tpu_torch.ops import kernels
from betacores_tpu_torch.utils import (BuildDraws, build_program, export_incremental_build,
                                       export_program, fixed_draws, load_program,
                                       load_program_file, save_program, stack_draws)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELECTIONS = 5


def _gaussian(weights=False, full=False):
    rng = np.random.default_rng(42)
    d = 3
    Sig = np.eye(d) * 2.0
    Siginv = torch.tensor(np.linalg.inv(Sig))
    X = torch.tensor(rng.normal(size=(40, d)))
    model = bc.gaussian.bundle(Siginv, float(np.linalg.slogdet(Sig)[1]))
    smp = bc.gaussian_conjugate_sampler(torch.zeros(d, dtype=torch.float64),
                                        torch.eye(d, dtype=torch.float64), Siginv)
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=16,
                            n_subsample_opt=None if full else 12, opt_itrs=6, i0=0.5,
                            use_beta=not weights)
    u = None
    if weights:
        u = torch.ones(40, dtype=torch.float64)
        u[:20] = 0.0
    b = make_incremental_builder(X, model, smp, cfg, data_weights=u)
    return b, X, u, init_state(8, d, beta=0.4, dtype=X.dtype, device="cpu")


def _logistic(refit_every=1, weights=False):
    rng = np.random.default_rng(7)
    d = 4
    X = rng.normal(size=(300, d))
    y = np.where(X @ np.ones(d) + 0.3 * rng.normal(size=300) > 0, 1.0, -1.0)
    Z = torch.tensor(y[:, None] * X, dtype=torch.float32)
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=30, n_subsample_opt=20,
                            opt_itrs=6, i0=0.5, use_beta=True, refit_every=refit_every)
    u = None
    if weights:
        u = torch.rand(300, generator=torch.Generator().manual_seed(1))
    b = make_incremental_builder(Z, bc.logreg.bundle(), bc.logreg_laplace_sampler(diag=weights),
                                 cfg, data_weights=u)
    # K1's route, or with data weights the composed one
    assert (b.fstep is None) == weights
    return b, Z, u, init_state(8, d, beta=0.3, device="cpu")


def _multiclass():
    """Full-candidate select over 9000 rows: select projects through K2."""
    rng = np.random.default_rng(3)
    K, d = 3, 3
    X = rng.normal(size=(9000, d))
    y = np.argmax(X @ rng.normal(size=(d, K)) + 0.5 * rng.normal(size=(9000, K)), axis=1)
    Z = torch.tensor(np.c_[X, y], dtype=torch.float32)
    cfg = IncrementalConfig(projection_dim=8, n_subsample_select=None, n_subsample_opt=20,
                            opt_itrs=4, i0=0.5, use_beta=True)
    b = make_incremental_builder(Z, bc.multiclass.bundle(K), bc.multiclass_laplace_sampler(K),
                                 cfg)
    assert kernels.maybe_fused(Z.shape[0])
    return b, Z, None, init_state(8, d + 1, beta=0.3, sampler_aux=torch.zeros(K * d),
                                  device="cpu")


PROBLEMS = {"gaussian": _gaussian, "gaussian_full_data": lambda: _gaussian(full=True),
            "logistic": _logistic, "logistic_lagged": lambda: _logistic(refit_every=2),
            "logistic_composed_lagged": lambda: _logistic(refit_every=2, weights=True),
            "multiclass": _multiclass, "weighted": lambda: _gaussian(weights=True)}


@pytest.fixture(scope="module")
def exported():
    """name -> (builder, data, weights, state, draws, artifact bytes)."""
    out = {}
    for name, make in PROBLEMS.items():
        b, X, u, st0 = make()
        draws = stack_draws(b, torch.Generator().manual_seed(11), st0, SELECTIONS)
        out[name] = (b, X, u, st0, draws, export_incremental_build(b, X, st0,
                                                                    draws_spec=draws))
    return out


def _args(X, u, draws, st0, itrs):
    itrs = torch.tensor(itrs)
    return (X, draws, st0, itrs) if u is None else (X, u, draws, st0, itrs)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_artifact_equals_the_live_build_bit_for_bit(exported, name):
    """One artifact, two build sizes: the same state as the live builder
    under the same draws, bit for bit; the live build from the generator
    the draws were stacked from is the same build."""
    b, X, u, st0, draws, data = exported[name]
    call = load_program(data)
    for itrs in (2, SELECTIONS):
        live = b.build(st0, itrs, fixed_draws(draws))
        art = call(*_args(X, u, draws, st0, itrs))
        for field in live._fields:
            assert torch.equal(getattr(art, field), getattr(live, field)), (name, itrs, field)
    assert int(art.m) >= 2
    gen = b.build(st0, SELECTIONS, b.generator_draws(torch.Generator().manual_seed(11)))
    assert torch.equal(gen.wts, live.wts) and torch.equal(gen.idcs, live.idcs)


def test_weighted_builder_exports_the_weighted_program(exported):
    """The builder's own data weights make the artifact take
    (data, data_weights, draws, state, itrs); it selects as the live build
    and never a row of weight zero."""
    b, X, u, st0, draws, data = exported["weighted"]
    art = load_program(data)(X, u, draws, st0, torch.tensor(SELECTIONS))
    sel = art.idcs[: int(art.m)]
    assert int(art.m) >= 2 and bool((sel >= 20).all()), sel
    with pytest.raises(Exception):
        load_program(data)(X, draws, st0, torch.tensor(2))


def test_file_roundtrip(exported, tmp_path):
    b, X, u, st0, draws, _ = exported["gaussian"]
    path = save_program(str(tmp_path / "build.pt2"), build_program(b), X, draws, st0,
                        torch.tensor(0))
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    art = load_program_file(path)(X, draws, st0, torch.tensor(3))
    live = b.build(st0, 3, fixed_draws(draws))
    assert torch.equal(art.idcs, live.idcs) and torch.equal(art.wts, live.wts)


def test_load_in_a_fresh_process_imports_no_model(exported, tmp_path):
    """A worker loads the artifact importing ``utils.export`` alone: no model
    family, no builder module, and runs it on the CPU (K1's op there is the
    plain version)."""
    b, X, u, st0, draws, data = exported["logistic"]
    (tmp_path / "a.pt2").write_bytes(data)
    torch.save({"X": X, "draws": tuple(draws), "st0": tuple(st0)}, tmp_path / "ops.pt")
    code = f"""
import sys, torch
from betacores_tpu_torch.utils.export import BuildDraws, load_program_file
call = load_program_file({str(tmp_path / 'a.pt2')!r}, device="cpu")
mods = sorted(m for m in sys.modules if m.startswith("betacores_tpu_torch."))
bad = [m for m in mods if m.startswith(("betacores_tpu_torch.models.",
                                        "betacores_tpu_torch.coresets.incremental",
                                        "betacores_tpu_torch.coresets.api"))
       and m != "betacores_tpu_torch.models.base"]
assert not bad, bad
assert not any(m == "jax" or m.startswith(("jax.", "betacores_tpu.")) for m in sys.modules)
from betacores_tpu_torch.coresets.state import CoresetState
ops = torch.load({str(tmp_path / 'ops.pt')!r})
st = call(ops["X"], BuildDraws(*ops["draws"]), CoresetState(*ops["st0"]), torch.tensor(3))
torch.save(st.wts, {str(tmp_path / 'wts.pt')!r})
print("ok", len(mods))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    live = b.build(st0, 3, fixed_draws(draws))
    assert torch.equal(torch.load(tmp_path / "wts.pt"), live.wts)


def test_indefinite_hessian_gives_the_nan_factor_in_the_artifact():
    """The Newton refit inside a program keeps C2: a target whose -H is
    not positive definite gets the reference's NaN factor (NaN on and below
    the diagonal), the live refit's bits."""
    from betacores_tpu_torch.inference import newton_laplace

    def fit(A, mu0):
        lj = lambda th: -0.5 * torch.sum((th @ A) * th, dim=-1)
        return newton_laplace(lj, lambda th: -(A @ th), lambda th: -A, mu0, n_iters=4,
                              with_inverse=True)

    A = torch.tensor([[1.0, 0.0], [0.0, -2.0]], dtype=torch.float64)   # indefinite
    mu0 = torch.tensor([0.3, -0.2], dtype=torch.float64)
    live = fit(A, mu0)
    art = load_program(export_program(fit, A, mu0))(A, mu0)
    lower = torch.tril_indices(2, 2)
    assert torch.isnan(art.prec_chol[lower[0], lower[1]]).all()
    assert torch.equal(torch.triu(art.prec_chol, 1), torch.zeros(2, 2, dtype=torch.float64))
    for got, want in zip(art, live):
        assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
    # a positive-definite target from the same program's artifact: finite
    B = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    assert torch.isfinite(load_program(export_program(fit, A, mu0))(B, mu0).prec_chol).all()


def test_artifact_matches_the_jax_artifact_under_its_draws():
    """The port's exported logistic build (K1's route), fed the JAX build's
    draws, against the JAX package's exported build: the same selections,
    weights within 5e-3 * max(1, max|w|)."""
    import jax
    import jax.numpy as jnp
    from test_torch_incremental import (ITRS, N, N_OPT, N_SEL, S, T, _cfgs, _jax_state,
                                        _np_state, problem as _problem, replay_jax_draws)

    from betacores_tpu.coresets.incremental import make_incremental_builder as jbuilder
    from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
    from betacores_tpu.models import logreg as jlogreg
    from betacores_tpu.utils import export_incremental_build as jexport
    from betacores_tpu.utils import load_program as jload

    Z = _problem.__wrapped__()
    itrs = ITRS // 2
    jcfg, tcfg = _cfgs(False, 1)
    key = jax.random.key(3)
    jst0 = _jax_state()
    jb = jbuilder(jnp.asarray(Z), jlogreg.bundle(), jsampler(), jcfg)
    jst = jload(jexport(jb, jnp.asarray(Z), jst0))(jnp.asarray(Z), key, jst0,
                                                    jnp.asarray(itrs, jnp.int32))
    rec = replay_jax_draws(key, jst0, itrs, jsampler(), N, S, T, N_SEL, N_OPT)
    draws = BuildDraws(torch.stack([z for z, _ in rec.sel]), torch.stack([i for _, i in rec.sel]),
                       torch.stack([z for z, _ in rec.opt]), torch.stack([i for _, i in rec.opt]))
    b = make_incremental_builder(torch.from_numpy(Z), bc.logreg.bundle(),
                                 bc.logreg_laplace_sampler(), tcfg)
    st0 = bc.state_from_numpy(_np_state(jst0), device="cpu")
    art = load_program(export_incremental_build(b, torch.from_numpy(Z), st0, draws_spec=draws))
    got = art(torch.from_numpy(Z), draws, st0, torch.tensor(itrs))
    want = _np_state(jst)
    assert int(got.m) == int(want["m"]) >= 2
    np.testing.assert_array_equal(got.idcs.numpy(), want["idcs"])
    w0 = want["wts"]
    np.testing.assert_allclose(got.wts.numpy(), w0, atol=5e-3 * max(1.0, np.abs(w0).max()))


@pytest.mark.parametrize("why", ["learn_beta", "contextual"])
def test_builders_the_program_cannot_express_raise(why):
    """A learn_beta build whose model's beta-gradient is the forward-mode
    derivative (a model made from a bare beta-likelihood) raises, naming
    the closed form; so does a contextual builder."""
    from betacores_tpu_torch.models.base import beta_gradient_from_autodiff

    d = 3
    b, X, _, st0 = _gaussian()
    if why == "learn_beta":
        jvp = beta_gradient_from_autodiff(b.model.beta_likelihood)
        model = b.model._replace(beta_gradient=jvp)
        b = make_incremental_builder(X, model, b.sampler,
                                     IncrementalConfig(projection_dim=8, n_subsample_select=16,
                                                       n_subsample_opt=12, opt_itrs=3,
                                                       use_beta=True, learn_beta=True))
        match = "closed form"
    else:
        b.ctx = object()
        match = "item 13"
    with pytest.raises(NotImplementedError, match=match):
        export_incremental_build(b, X, st0, draws_spec=BuildDraws(
            torch.zeros(1, 8, d), None, torch.zeros(1, 3, 8, d), None))


# --- the ops ----------------------------------------------------------------

def test_k1_op_cpu_kernel_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    R, d, M_pad, s_pad, S = 136, 5, 128, 128, 24
    xin = torch.randn(R, d + 1, generator=g)
    xin[:, d] = (torch.rand(R, generator=g) > 0.2).float()
    ops = (xin, torch.randn(s_pad, d, generator=g), torch.randn(1, d, generator=g),
           torch.tril(torch.randn(d, d, generator=g)) + 3 * torch.eye(d),
           torch.rand(1, M_pad, generator=g), torch.rand(1, M_pad, generator=g) * 0.1,
           torch.rand(1, M_pad, generator=g) * 0.1, torch.tensor([0.3, 5.0]),
           torch.tensor([0.1, 0.19, 0.002]))
    for use_beta in (False, True):
        got = torch.ops.betacores_torch.logreg_adam_step(*ops, S, use_beta)
        want = kernels.logreg_adam_step_plain(*ops, S, use_beta)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)
        torch.library.opcheck(torch.ops.betacores_torch.logreg_adam_step.default,
                              (*ops, S, use_beta))
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            outs = torch.ops.betacores_torch.logreg_adam_step(
                *(mode.from_tensor(t) for t in ops), S, use_beta)
        assert [tuple(o.shape) for o in outs] == [(1, M_pad)] * 3


def test_k2_op_cpu_kernel_is_the_plain_version():
    g = torch.Generator().manual_seed(1)
    N, K, d, S = 300, 4, 5, 17
    z = torch.cat([torch.randn(N, d, generator=g),
                   torch.randint(0, K, (N, 1), generator=g).float()], 1)
    th = torch.randn(S, K * d, generator=g)
    beta = torch.tensor(0.3)
    for use_beta, b in ((False, 1.0), (True, 0.3), (True, beta)):
        got = kernels.multiclass_projection(z, th, K, b, use_beta)
        assert torch.equal(got, kernels.multiclass_projection_plain(z, th, K, b, use_beta))
        bt = b if isinstance(b, torch.Tensor) else None
        bf = 1.0 if bt is not None else b
        torch.library.opcheck(torch.ops.betacores_torch.multiclass_projection.default,
                              (z, th, K, bf, bt, use_beta))
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            out = torch.ops.betacores_torch.multiclass_projection(
                mode.from_tensor(z), mode.from_tensor(th), K, bf,
                None if bt is None else mode.from_tensor(bt), use_beta)
        assert tuple(out.shape) == (N, S) and out.dtype == got.dtype
