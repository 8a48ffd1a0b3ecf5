"""The port's Hilbert slice against the JAX package on the CPU in float64
(the conftest's x64): ``HilbertCoreset``, ``refine_weights`` /
``refine()`` and ``ShardedHilbertCoreset``.

- ``HilbertCoreset`` is fed the JAX object's own samples and subsample
  indices through its one draws method (``_draws``), with and without
  ``data_weights`` and ``n_subsample``: the same ``get()`` indices and row
  map, and weights within 1e-10 of max|w| (the same GIGA arithmetic in
  float64).
- ``refine_weights`` and the object API's ``refine()`` replay the JAX
  call's own noise and subsample (the pair ``(z, idx)``), in ll and beta
  modes and with ``data_weights``. FISTA runs its 600 iterations on both
  sides, a contraction on a support of independent columns, so the polished
  weights are held within 1e-9 of max|w|.
- ``ShardedHilbertCoreset`` runs in gloo worlds of 1, 2 and 4 ranks
  (tests/torch_dist_worker.py) on 611 rows (not divisible by 2 or 4), in
  ll and beta (0.3) modes: the same columns as the single-device port's
  GIGA and as the JAX sharded class, weights within 1e-10 of max|w|, and
  on one rank the single-device port's weights bit for bit (the step is
  the single-device step's arithmetic).
- The multiclass projection routes to the fused projection (K2; its plain
  version is attached on the CPU) at 8192 rows and to the plain one below,
  in each of the three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betacores_tpu as jbc
import betacores_tpu_torch as bc
from betacores_tpu.coresets.refine import refine_weights as jrefine
from betacores_tpu.inference import gaussian_conjugate_sampler as jgauss_sampler
from betacores_tpu.inference.samplers import logreg_laplace_sampler as jlr_sampler
from betacores_tpu.models import gaussian as jg
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu.ops.projection import draw_subsample as jdraw_subsample
from betacores_tpu.parallel import ShardedHilbertCoreset as JSharded
from betacores_tpu.parallel import make_mesh as jmake_mesh
from betacores_tpu.parallel import shard_data as jshard_data
from betacores_tpu.utils.prng import KeySequence as JKeySequence
from betacores_tpu_torch import snnls
from betacores_tpu_torch.coresets import refine_weights, state_from_numpy
from betacores_tpu_torch.inference import gaussian_conjugate_sampler, logreg_laplace_sampler
from betacores_tpu_torch.models import gaussian, logreg, multiclass
from betacores_tpu_torch.ops import kernels
from betacores_tpu_torch.ops.projection import project_beta, project_ll
from betacores_tpu_torch.parallel import ShardedHilbertCoreset, make_mesh, world_of_one
from torch_dist_worker import run_world

torch.set_num_threads(1)

D_G, N_G, S_G, SEED = 4, 611, 32, 7
SHARD_ITRS, TRACE_ITRS, BETA = 30, 10, 0.3


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, where=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=where)


@pytest.fixture(scope="module")
def gauss():
    """tests/test_parallel.py's known-covariance Gaussian (Sig = 3 I), 611
    rows, with both packages' model and conjugate sampler."""
    rng = np.random.default_rng(11)
    Sig = 3.0 * np.eye(D_G)
    Siginv = np.linalg.inv(Sig)
    logdet = float(np.linalg.slogdet(Sig)[1])
    X = rng.multivariate_normal(np.zeros(D_G), Sig, N_G)
    prior = (np.zeros(D_G), np.eye(D_G), Siginv)
    return dict(X=X, spec=("gaussian", *prior, logdet),
                jmodel=jg.bundle(jnp.asarray(Siginv), logdet),
                jsampler=jgauss_sampler(*(jnp.asarray(a) for a in prior)),
                model=gaussian.bundle(t(Siginv), logdet),
                sampler=gaussian_conjugate_sampler(*(t(a) for a in prior)))


class _JaxDrawn(bc.HilbertCoreset):
    """The port's class fed given draws through its one draws method."""

    draws = None

    def _draws(self, n_subsample):
        samples, sub = self.draws
        assert (sub is None) == (n_subsample is None)
        return t(samples), None if sub is None else t(sub)


def _jax_hilbert_draws(jprj, X, seed, n_subsample):
    """The samples and subsample indices the JAX HilbertCoreset draws
    from its key stream at ``seed`` (coresets/api.py:498-512)."""
    keys = JKeySequence(seed)
    d = X.shape[1]
    samples, _ = jprj.sampler(keys(), jprj.projection_dimension, jnp.zeros(1),
                              jnp.zeros((1, d)), jnp.zeros(d))
    if n_subsample is None:
        return np.asarray(samples), None
    n = min(X.shape[0], n_subsample)
    return np.asarray(samples), np.asarray(jax.random.randint(keys(), (n,), 0, X.shape[0]))


@pytest.mark.parametrize("n_subsample,weighted,solver", [
    (None, False, "GIGA"), (200, False, "GIGA"), (None, True, "GIGA"), (200, True, "GIGA"),
    (None, False, "AccIHT"), (None, False, "OrthoPursuit")])
def test_hilbert_coreset_matches_jax(gauss, n_subsample, weighted, solver):
    X = gauss["X"]
    u = None
    if weighted:        # row multiplicities, with zero-weight rows that leave the pool
        u = np.random.default_rng(3).integers(0, 3, size=N_G).astype(np.float64)
    jprj = jbc.BlackBoxProjector(gauss["jsampler"], S_G, model=gauss["jmodel"])
    prj = bc.BlackBoxProjector(gauss["sampler"], S_G, model=gauss["model"])
    kw = dict(n_subsample=n_subsample, seed=SEED, data_weights=u)
    ja = jbc.HilbertCoreset(jnp.asarray(X), jprj, snnls=getattr(jbc.snnls, solver), **kw)
    _JaxDrawn.draws = _jax_hilbert_draws(jprj, X, SEED, n_subsample)
    ta = _JaxDrawn(X, prj, snnls=getattr(snnls, solver), device="cpu", **kw)
    np.testing.assert_array_equal(ta._row_map, ja._row_map)
    bnorm = float(np.linalg.norm(np.asarray(ja.snnls.b)))
    if weighted:
        assert len(ta._row_map) < (n_subsample or N_G)
    for m in (1, 4, 10):
        ja.build(m - ja.size(), m)
        ta.build(m - ta.size(), m)
        (w, p, i), (jw, jp, ji) = ta.get(), ja.get()
        np.testing.assert_array_equal(i, np.asarray(ji))
        _close(w, jw, 1e-10, f"{solver} at {m}")
        np.testing.assert_array_equal(p, np.asarray(jp))
        assert ta.error() == pytest.approx(ja.error(), rel=1e-10, abs=1e-10 * bnorm)
    ja.optimize()
    ta.optimize()
    _close(ta.get()[0], ja.get()[0], 1e-9, "after optimize()")
    ta.reset()
    assert ta.size() == 0 and ta.snnls.size() == 0


def test_hilbert_coreset_contract(gauss):
    """Its own draws, the size guard and data_weights' shape check, and the
    card by default."""
    X = gauss["X"]
    prj = bc.BlackBoxProjector(gauss["sampler"], S_G, model=gauss["model"])
    a = bc.HilbertCoreset(X, prj, seed=1, device="cpu")
    b = bc.HilbertCoreset(X, prj, seed=1, device="cpu")
    a.build(5, 5)
    b.build(5, 5)
    np.testing.assert_array_equal(a.get()[0], b.get()[0])
    assert a.size() == 5 and a.state.m == 5
    with pytest.raises(ValueError, match="exceeds"):
        a.build(3, 6)
    with pytest.raises(ValueError, match="data_weights"):
        bc.HilbertCoreset(X, prj, data_weights=np.ones(3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bc.HilbertCoreset(X, prj)


# --- refine ---------------------------------------------------------------

N_LR, D_LR, S_LR, N_SAMPLES = 60, 3, 16, 64


@pytest.fixture(scope="module")
def logistic():
    """A small logistic problem and a JAX SparseVI/BetaCoreset state after
    4 deterministic selections under the Laplace sampler."""
    rng = np.random.default_rng(5)
    th = rng.normal(size=D_LR)
    X = rng.normal(size=(N_LR, D_LR))
    y = np.where(X @ th + 0.5 * rng.normal(size=N_LR) > 0, 1.0, -1.0)
    Z = y[:, None] * X
    u = rng.integers(0, 3, size=N_LR).astype(np.float64)
    return Z, u


def _jax_state(Z, use_beta, u):
    cls = jbc.BetaCoreset if use_beta else jbc.SparseVICoreset
    pcls = jbc.BetaBlackBoxProjector if use_beta else jbc.BlackBoxProjector
    kw = dict(beta=0.4) if use_beta else {}
    ja = cls(jnp.asarray(Z), pcls(jlr_sampler(), S_LR, model=jlogreg.bundle()), opt_itrs=20,
             step_sched=lambda i: 0.5 / (1.0 + i), seed=2, data_weights=u,
             dedup_select=True, **kw)
    ja.build(4, 4)
    return ja


def _jax_refine_draws(key, st, n_subsample, N):
    """The noise and subsample the JAX ``refine_weights(key, ...)`` draws."""
    k_samp, k_sub = jax.random.split(key)
    z = jlr_sampler().draw_noise(k_samp, N_SAMPLES, st.wts, st.pts, st.sampler_aux)
    sub = None if n_subsample is None else jdraw_subsample(k_sub, N, n_subsample)[0]
    return t(z), None if sub is None else t(sub)


@pytest.mark.parametrize("use_beta,n_subsample,weighted", [
    (False, None, False), (True, None, False), (False, 30, False), (True, 30, True),
    (False, None, True)])
def test_refine_weights_matches_jax(logistic, use_beta, n_subsample, weighted):
    Z, u = logistic
    u = u if weighted else None
    ja = _jax_state(Z, use_beta, u)
    st = ja.state
    key = jax.random.key(9)
    want = jrefine(key, jnp.asarray(Z), jlogreg.bundle(), jlr_sampler(), st,
                   n_samples=N_SAMPLES, n_subsample=n_subsample, use_beta=use_beta,
                   data_weights=u)
    tst = state_from_numpy({k: np.asarray(v) for k, v in st._asdict().items()}, device="cpu")
    got = refine_weights(_jax_refine_draws(key, st, n_subsample, N_LR), t(Z), logreg.bundle(),
                         logreg_laplace_sampler(), tst, n_samples=N_SAMPLES,
                         n_subsample=n_subsample, use_beta=use_beta,
                         data_weights=None if u is None else t(u))
    w, jw = got.wts.numpy(), np.asarray(want.wts)
    assert not np.array_equal(jw, np.asarray(st.wts)), "the polish was not kept"
    _close(w, jw, 1e-9)
    _close(got.sampler_aux.numpy(), want.sampler_aux, 1e-10)
    assert (w >= 0).all() and not (w > 0)[np.asarray(st.wts) <= 0].any()   # no new column


def test_refine_matches_jax_through_the_api(logistic):
    """``refine()`` of the object API under the JAX object's next key,
    with ``data_weights``; and its draws contract."""
    Z, u = logistic
    for use_beta in (False, True):
        ja = _jax_state(Z, use_beta, u)
        cls = bc.BetaCoreset if use_beta else bc.SparseVICoreset
        pcls = bc.BetaBlackBoxProjector if use_beta else bc.BlackBoxProjector
        kw = dict(beta=0.4) if use_beta else {}
        ta = cls(Z, pcls(logreg_laplace_sampler(), S_LR, model=logreg.bundle()), seed=2,
                 data_weights=u, device="cpu", **kw)
        ta.state = state_from_numpy({k: np.asarray(v) for k, v in ja.state._asdict().items()},
                                    device="cpu")
        key = JKeySequence(ja.keys._key)()      # the key ja.refine() takes next
        ta._refine_draws = lambda: _jax_refine_draws(key, ja.state, None, N_LR)
        ja.refine(n_samples=N_SAMPLES)
        ta.refine(n_samples=N_SAMPLES)
        _close(ta.state.wts.numpy(), ja.state.wts, 1e-9, f"use_beta={use_beta}")
    with pytest.raises(ValueError, match="subsample"):
        ta._refine_draws = lambda: _jax_refine_draws(key, ja.state, None, N_LR)
        ta.refine(n_samples=N_SAMPLES, n_subsample=10)
    # its own generator: the same seed polishes the same way
    states = []
    for _ in range(2):
        tb = bc.SparseVICoreset(Z, bc.BlackBoxProjector(logreg_laplace_sampler(), S_LR,
                                                        model=logreg.bundle()),
                                opt_itrs=20, seed=4, dedup_select=True, device="cpu")
        tb.build(3, 3)
        before = tb.state.wts.numpy()
        tb.refine(n_samples=N_SAMPLES, n_subsample=20)
        states.append(tb.state.wts.numpy())
        assert (states[-1] >= 0).all() and not (states[-1] > 0)[before <= 0].any()
    np.testing.assert_array_equal(*states)


# --- the sharded Hilbert coreset -----------------------------------------

@pytest.fixture(scope="module")
def sharded_runs(gauss):
    """Each mesh's ranks' reports of the ll and beta jobs."""
    X = gauss["X"]
    samples, _ = gauss["jsampler"](jax.random.key(SEED), S_G, jnp.zeros(1),
                                   jnp.zeros((1, D_G)), None)
    samples = np.array(samples)
    job = dict(kind="hilbert", data=X, model=gauss["spec"], samples=samples,
               trace=TRACE_ITRS, itrs=SHARD_ITRS - TRACE_ITRS)
    jobs = {"ll": job, "beta": dict(job, beta=BETA)}
    out = {shape: run_world(*shape, jobs) for shape in ((1, 1), (2, 1), (4, 1))}
    return samples, out


def _single_giga(gauss, samples, beta, itrs):
    model = gauss["model"]
    X = t(gauss["X"])
    vecs = (project_ll(model, X, t(samples)) if beta is None
            else project_beta(model, X, t(samples), torch.tensor(BETA, dtype=torch.float64)))
    g = snnls.GIGA(vecs.T, vecs.sum(dim=0))
    return g, g.build_trace(itrs).numpy()


@pytest.mark.parametrize("mode", ["ll", "beta"])
def test_sharded_hilbert_matches_single_device_and_jax(gauss, sharded_runs, mode):
    samples, out = sharded_runs
    beta = None if mode == "ll" else BETA
    g, trace = _single_giga(gauss, samples, beta, SHARD_ITRS)
    # the JAX sharded class on its virtual mesh (tests/test_parallel.py's)
    jmesh = jmake_mesh(4, 2)
    ds, n_true = jshard_data(jnp.asarray(gauss["X"]), jmesh)
    jsh = JSharded(ds, n_true, gauss["jmodel"], jnp.asarray(samples), jmesh, beta=beta)
    jsh.build(SHARD_ITRS)
    jw = jsh.weights()
    for shape, ranks in out.items():
        for rep in ranks:
            r = rep["jobs"][mode]
            w = r["w"]
            np.testing.assert_array_equal(w > 0, g.weights() > 0, err_msg=str(shape))
            np.testing.assert_array_equal(w > 0, jw > 0, err_msg=str(shape))
            _close(w, g.weights(), 1e-10, f"{shape} vs the single-device port")
            _close(w, jw, 1e-10, f"{shape} vs JAX")
            _close(r["w_trace"], trace[TRACE_ITRS - 1], 1e-10, f"{shape} trace")
            assert r["error"] == pytest.approx(g.error(), rel=1e-9)
            assert r["size"] == g.size() and r["latched"] == g.reached_numeric_limit
            gw, gp, gi = r["get"]
            np.testing.assert_array_equal(gi, np.flatnonzero(w > 0))
            np.testing.assert_array_equal(gp, gauss["X"][gi])
        # the trace rows of all ranks, in rank order, are the global trace
        rows = np.concatenate([rep["jobs"][mode]["trace"] for rep in ranks
                               if rep["ax"][1] == 0], axis=1)[:, :N_G]
        _close(rows, trace[:TRACE_ITRS], 1e-10, f"{shape} trace rows")
    one = out[(1, 1)][0]["jobs"][mode]
    np.testing.assert_array_equal(one["w"], g.weights())     # one rank: the same arithmetic


# --- the multiclass projection's route -----------------------------------

def test_multiclass_hilbert_routes_to_the_fused_projection(rng):
    """At FUSED_MIN_ROWS rows HilbertCoreset, refine_weights over every row
    and ShardedHilbertCoreset (a gloo world of one) project through the
    bundle's fused field, K2 (its plain version on the CPU); one row fewer
    goes to the plain composition. Every result equals the plain bundle's."""
    K, d, S = 3, 4, 8
    n = kernels.FUSED_MIN_ROWS
    X = rng.normal(size=(n, d))
    Z = torch.from_numpy(np.c_[X, rng.integers(0, K, size=n)].astype(np.float32))
    TH = torch.from_numpy(rng.normal(size=(S, K * d)).astype(np.float32))
    calls = []

    def stub_ll(pts, th):
        calls.append(("ll", pts.shape[0]))
        return kernels.multiclass_projection_plain(pts, th, K)

    def stub_beta(pts, th, beta):
        calls.append(("beta", pts.shape[0]))
        return kernels.multiclass_projection_plain(pts, th, K, beta, True)

    fused = multiclass.bundle(K)._replace(fused_ll_projection=stub_ll,
                                          fused_beta_projection=stub_beta)
    plain = multiclass.bundle(K, fused=False)
    smp = bc.fixed_sampler(TH)
    for rows in (n - 1, n):
        calls.clear()
        got, want = (bc.HilbertCoreset(Z[:rows], bc.BlackBoxProjector(smp, S, model=m),
                                       device="cpu") for m in (fused, plain))
        assert calls == ([("ll", n)] if rows == n else [])
        got.build(3, 3)
        want.build(3, 3)
        np.testing.assert_array_equal(got.get()[0], want.get()[0])
    st = bc.init_state(64, d + 1, dtype=torch.float32, device="cpu")
    zeros = torch.zeros((S, K * d))
    for m in (fused, plain):
        calls.clear()
        refine_weights((zeros, None), Z, m, smp, st, n_samples=S, use_beta=True)
    assert calls == []                          # the plain bundle's pass
    refine_weights((zeros, None), Z, fused, smp, st, n_samples=S, use_beta=True)
    assert calls == [("beta", n)]               # the data, not the 64-slot buffer
    calls.clear()
    with world_of_one("gloo"):
        mesh = make_mesh(1, 1)
        sh = ShardedHilbertCoreset(Z, n, fused, TH, mesh, beta=0.3)
        ref = ShardedHilbertCoreset(Z, n, plain, TH, mesh, beta=0.3)
        sh.build(3)
        ref.build(3)
        np.testing.assert_array_equal(sh.weights(), ref.weights())
    assert calls == [("beta", n)]
