"""The port's sparse NNLS solvers (betacores_tpu_torch/snnls) against the
JAX package's solvers and the float64 oracles, on the CPU in float64 (the
conftest's x64).

- Every solver against its JAX counterpart on the same A and b over
  tests/test_snnls.py's pathological battery (``gendata`` and its CASES,
  one parametrised test). The battery is built of ties: identical columns
  (``bin``), columns along one direction (the colinear data) and exact
  fits once the support spans the D rows, where the next pick is an
  argmax over rounding noise (or, for OMP and LAR, over the FISTA
  re-solve's error) and either package may take either column. So after
  each of the battery's builds (1, 3 and 6 iterations in all) the port
  must reach the JAX objective (the error within rel 1e-6, abs 1e-6 of
  max(1, ||b||)), the same latch until b is fitted, and the battery's invariants (w >= 0,
  nnz <= iterations), and, wherever the weights are determined (it picked
  the same columns, and they are linearly independent), the same weights
  within rtol 1e-7 and atol 1e-9 of max(1, max|w|). On a generic
  problem without ties every solver must give the JAX weights at every
  build. The sampling solvers fold the JAX solver's own draws, so their
  counts are exact.
- GIGA, Frank-Wolfe and OMP against oracle/snnls.py, and the FISTA NNLS
  against oracle/opt.py's Lawson-Hanson, at tests/test_snnls.py's own
  tolerances.
- The driver's contract: ``build_trace`` equals sequential builds, the
  latch after a forced failure, ``set_tolerance`` acting between builds,
  input validation, AccIHT's tie rule and ``nnls_on_support`` with column
  N - 1 in the support (the scatter that adds and never sets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu import snnls as jsnnls
from betacores_tpu.utils.prng import KeySequence as JKeySequence
from betacores_tpu_torch import snnls
from betacores_tpu_torch.utils import errors
from oracle.opt import nnls_lawson_hanson
from oracle.snnls import OracleFrankWolfe, OracleGIGA, OracleOrthoPursuit
from test_snnls import CASES, gendata

torch.set_num_threads(1)

GREEDY = ("GIGA", "FrankWolfe", "OrthoPursuit", "LAR", "AccIHT")
SAMPLING = ("ImportanceSampling", "UniformSampling")
RTOL, ATOL = 1e-7, 1e-9        # of max(1, max|w|): float64, same arithmetic
FLOOR = 1e-6                   # of max(1, ||b||): the FISTA re-solve's accuracy


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _close(got, want, where):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))),
                               err_msg=where)


# (solver, shape, max_support) -> the first JAX solver made for it. Each JAX
# solver compiles its own programs, which take every problem of its shape
# as arguments: sharing them across the battery's problems of one shape
# saves most of this file's time
_COMPILED = {}


def jax_solver(name, A, b, **kw):
    j = getattr(jsnnls, name)(jnp.asarray(A), jnp.asarray(b), **kw)
    first = _COMPILED.setdefault((name, A.shape, kw.get("max_support")), j)
    for attr in ("_jit_build", "_jit_trace", "_jit_optimize", "_jit_solve",
                 "_jit_solve_trace"):
        if hasattr(first, attr):
            setattr(j, attr, getattr(first, attr))
    return j


def _fold_jax_draws(port, jax_alg, seed):
    """Makes ``port`` (a sampling solver) fold the draws the JAX solver
    ``jax_alg`` makes from its own key stream at ``seed``."""
    keys = JKeySequence(seed)
    ps = jax_alg.ps

    def draw(cap):
        return torch.from_numpy(np.array(jax.random.choice(keys(), ps.shape[0],
                                                             shape=(cap,), p=ps)))

    port._draw = draw


@pytest.mark.parametrize("dist,N,D", CASES)
def test_solvers_match_jax(dist, N, D, rng):
    x = gendata(rng, N, D, dist)
    if x.shape[0] == 0:
        pytest.skip("degenerate draw")
    A, b = x.T, x.sum(axis=0)
    if np.linalg.norm(b) == 0:
        pytest.skip("zero target")
    for name in GREEDY + SAMPLING:
        if name in SAMPLING:
            j = getattr(jsnnls, name)(jnp.asarray(A), jnp.asarray(b), seed=3)
            p = getattr(snnls, name)(t(A), t(b), seed=3)
            _fold_jax_draws(p, j, 3)
        else:
            kw = dict(max_support=x.shape[0])
            j = jax_solver(name, A, b, **kw)
            p = getattr(snnls, name)(t(A), t(b), **kw)
        m_total, floor = 0, FLOOR * max(1.0, float(np.linalg.norm(b)))
        for m in (1, 3, 6):
            j.build(m - m_total)
            p.build(m - m_total)
            m_total = m
            w, jw = p.weights(), j.weights()
            assert p.error() == pytest.approx(j.error(), rel=1e-6, abs=floor), name
            if j.error() > floor:      # past a fit the monotone check compares noise
                assert p.reached_numeric_limit == j.reached_numeric_limit, name
            assert (w >= 0).all() and ((w > 0).sum() <= m or name == "LAR"), name
            supp = w > 0
            if (supp == (jw > 0)).all() and np.linalg.matrix_rank(A[:, supp]) == supp.sum():
                _close(w, jw, f"{name} after {m}")
        p.reset()
        assert p.size() == 0 and not p.reached_numeric_limit


@pytest.mark.parametrize("dist", ["gauss", "bin", "axis"])
@pytest.mark.parametrize("name,ocls", [("GIGA", OracleGIGA), ("FrankWolfe", OracleFrankWolfe),
                                       ("OrthoPursuit", OracleOrthoPursuit)])
def test_golden_vs_oracle(name, ocls, dist, rng):
    x = gendata(rng, 30, 6, dist)
    A, b = x.T, x.sum(axis=0)
    alg = getattr(snnls, name)(t(A), t(b), max_support=30)
    oalg = ocls(A, b)
    alg.build(12)
    oalg.build(12)
    np.testing.assert_allclose(alg.weights(), oalg.weights(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(alg.error(), oalg.error(), rtol=1e-6, atol=1e-9)


def test_nnls_fista_matches_lawson_hanson(rng):
    for _ in range(5):
        D, N = 12, 8
        A = rng.normal(size=(D, N))
        b = rng.normal(size=D) + A @ np.abs(rng.normal(size=N))
        w_lh = nnls_lawson_hanson(A, b)
        w = snnls.nnls_on_support(t(A), t(b), torch.ones(N, dtype=torch.bool), N, n_iters=2000)
        np.testing.assert_allclose(w.numpy(), w_lh, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("width", [3, 5])
def test_nnls_on_support_keeps_the_last_column(width, rng):
    """Column N - 1 in a support narrower than the block: the padding slots
    point at it too and add 0, so its weight survives (a set would let a
    padding slot's 0 overwrite it). Against the JAX solver, and against
    Lawson-Hanson on the support's columns."""
    D, N = 10, 12
    A = rng.normal(size=(D, N))
    sup = np.zeros(N, dtype=bool)
    sup[[2, 7, N - 1]] = True
    b = A[:, sup] @ np.array([0.5, 1.5, 2.0]) + 0.01 * rng.normal(size=D)
    w = snnls.nnls_on_support(t(A), t(b), torch.from_numpy(sup), width, n_iters=2000).numpy()
    jw = np.asarray(jsnnls.nnls_on_support(jnp.asarray(A), jnp.asarray(b), jnp.asarray(sup),
                                           width, n_iters=2000))
    want = np.zeros(N)
    want[sup] = nnls_lawson_hanson(A[:, sup], b)
    assert w[N - 1] > 1.0
    np.testing.assert_allclose(w, jw, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(w, want, rtol=1e-5, atol=1e-6)


def test_support_slots_pad_with_the_last_column():
    sup = torch.tensor([False, True, False, True, True, False])
    idx, valid = snnls.nnls.support_slots(sup, 5)
    assert idx.tolist() == [1, 3, 4, 5, 5] and valid.tolist() == [True] * 3 + [False] * 2
    idx, valid = snnls.nnls.support_slots(sup, 2)     # more flagged than slots
    assert idx.tolist() == [1, 3] and valid.tolist() == [True, True]


@pytest.mark.parametrize("name", GREEDY)
def test_build_trace_matches_sequential_builds(name, rng):
    A = rng.normal(size=(10, 40))
    b = A.sum(axis=1)
    seq = getattr(snnls, name)(t(A), t(b))
    tr = getattr(snnls, name)(t(A), t(b))
    ws = tr.build_trace(6).numpy()
    assert ws.shape == (6, 40)
    for m in range(1, 7):
        seq.build(1)
        np.testing.assert_allclose(ws[m - 1], seq.weights(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tr.weights(), seq.weights(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", GREEDY + SAMPLING)
def test_solver_matches_jax_without_ties(name, rng):
    """A generic problem (N = 40 > D = 10, no ties): the weights after every
    build, and the traces, equal the JAX solver's."""
    A = rng.normal(size=(10, 40))
    b = np.abs(A) @ rng.uniform(size=40)
    if name in SAMPLING:
        j = getattr(jsnnls, name)(jnp.asarray(A), jnp.asarray(b), seed=1)
        p = getattr(snnls, name)(t(A), t(b), seed=1)
        _fold_jax_draws(p, j, 1)
    else:
        j = getattr(jsnnls, name)(jnp.asarray(A), jnp.asarray(b))
        p = getattr(snnls, name)(t(A), t(b))
    for m in range(1, 6):
        j.build(1)
        p.build(1)
        _close(p.weights(), j.weights(), f"{name} after {m}")
    if name in GREEDY:
        ws, jws = p.build_trace(4).numpy(), np.asarray(j.build_trace(4))
        for m in range(4):
            _close(ws[m], jws[m], f"{name} trace row {m}")
        assert p.reached_numeric_limit == j.reached_numeric_limit


def test_latch_after_forced_failure(rng):
    """With a tolerance GIGA's select guard cannot meet, every iteration
    fails: the first reverts, the second latches, and nothing moves after;
    as the JAX solver does."""
    A = rng.normal(size=(5, 30))
    b = rng.normal(size=5)
    old = errors.get_tolerance()
    try:
        errors.set_tolerance(1e10)
        jax_errors = jsnnls.base.errors
        jold = jax_errors.get_tolerance()
        jax_errors.set_tolerance(1e10)
        try:
            g, jg = snnls.GIGA(t(A), t(b)), jsnnls.GIGA(jnp.asarray(A), jnp.asarray(b))
            st = snnls.build(g._step_fn(), g._error, g.w, 1)
            assert not bool(st.latched) and bool(st.retried)
            g.build(3)
            jg.build(3)
        finally:
            jax_errors.set_tolerance(jold)
    finally:
        errors.set_tolerance(old)
    assert g.reached_numeric_limit and jg.reached_numeric_limit
    assert g.size() == 0 and (g.weights() == 0).all()
    g.build(3)                                  # latched: returns at once
    assert g.size() == 0


def test_set_tolerance_acts_between_builds(rng):
    A = rng.normal(size=(5, 30))
    b = rng.normal(size=5)
    g = snnls.GIGA(t(A), t(b))
    g.build(3)
    assert g.size() > 0 and not g.reached_numeric_limit
    old = errors.get_tolerance()
    try:
        errors.set_tolerance(1e10)
        g.reset()
        g.build(3)
        assert g.reached_numeric_limit, "set_tolerance() had no effect on the next build"
    finally:
        errors.set_tolerance(old)
    g.reset()
    g.build(3)
    assert g.size() > 0 and not g.reached_numeric_limit


def test_input_validation():
    cpu = dict(device="cpu")
    with pytest.raises(ValueError):
        snnls.GIGA(np.zeros((3, 2)), np.ones(3), **cpu)          # zero columns
    with pytest.raises(ValueError):
        snnls.GIGA(np.ones((3, 2)), np.ones(4), **cpu)           # shape mismatch
    for bad in ("abc", [[1.0, 2.0], [3.0]], np.array([[1 + 1j]]), np.array([[True]])):
        with pytest.raises(ValueError):
            snnls.FrankWolfe(bad, np.ones(1), **cpu)
    with pytest.raises(ValueError):
        snnls.LAR(np.ones((2, 3)), np.zeros(2), **cpu)          # zero target
    with pytest.raises(errors.NumericalPrecisionError):
        snnls.GIGA(np.ones((2, 3)), np.zeros(2), **cpu)
    with pytest.raises(ValueError):
        snnls.AccIHT(np.ones((2, 3)), np.ones(2), init="ones", **cpu)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            snnls.GIGA(np.ones((3, 2)), np.ones(3))             # the card by default
    # a tensor keeps its device and dtype; numpy input takes the asked device
    g = snnls.GIGA(torch.ones((3, 2), dtype=torch.float32), torch.ones(3, dtype=torch.float32))
    assert g.A.device.type == "cpu" and g.w.dtype == torch.float32


def test_accIHT_ties_resolve_to_the_lower_index():
    x = torch.tensor([1.0, 2.0, 2.0, 2.0, -1.0])
    out = snnls.project_nonneg_topk(x, 2).numpy()
    np.testing.assert_array_equal(out, [0.0, 2.0, 2.0, 0.0, 0.0])
    np.testing.assert_array_equal(out, np.asarray(jsnnls.project_nonneg_topk(jnp.asarray(x.numpy()), 2)))


def test_optimize_matches_jax(rng):
    """The exact re-solve on the support after a greedy build, for every
    solver of the battery that has one."""
    x = gendata(rng, 8, 8, "axis")
    A, b = x.T, x.sum(axis=0)
    for name in ("GIGA", "OrthoPursuit", "AccIHT"):
        p = getattr(snnls, name)(t(A), t(b), max_support=8)
        j = getattr(jsnnls, name)(jnp.asarray(A), jnp.asarray(b), max_support=8)
        p.build(8)
        j.build(8)
        p.optimize()
        j.optimize()
        _close(p.weights(), j.weights(), name)
        assert p.error() < 1e-5 * np.linalg.norm(b)
        assert p.reached_numeric_limit == j.reached_numeric_limit


def test_sampling_under_jax_draws_and_generator(rng):
    """Two builds folding the JAX draws give the JAX weights exactly; the
    port's own draws are unbiased as tests/test_snnls.py asks of JAX's."""
    x = gendata(rng, 50, 4, "gauss")
    A, b = x.T, x.sum(axis=0)
    for name in SAMPLING:
        j = getattr(jsnnls, name)(jnp.asarray(A), jnp.asarray(b), seed=5)
        p = getattr(snnls, name)(t(A), t(b), seed=5)
        _fold_jax_draws(p, j, 5)
        for itrs in (7, 300):
            j.build(itrs)
            p.build(itrs)
            np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
            np.testing.assert_allclose(p.weights(), j.weights(), rtol=1e-14)
        own = getattr(snnls, name)(t(A), t(b), seed=3)
        own.build(500)
        w = own.weights()
        assert (w >= 0).all() and (w > 0).sum() > 5
        assert np.linalg.norm(A @ w - b) / np.linalg.norm(b) < 0.5
        d = snnls.sampling_draws(torch.Generator().manual_seed(0), own.ps, 64)
        counts, w2 = snnls.sampling_fold(own.ps, torch.zeros_like(own.ps), d, 10)
        assert float(counts.sum()) == 10.0


def test_exports_match_the_jax_package():
    """Every name the JAX package's snnls exports has a counterpart here."""
    missing = [n for n in jsnnls.__all__ if not hasattr(snnls, n)]
    assert not missing, missing
    assert set(jsnnls.__all__) <= set(snnls.__all__)


def _first_departure(trace, ref):
    """The first iteration (from 1) whose columns differ, or None."""
    diff = ((np.asarray(trace) > 0) != (np.asarray(ref) > 0)).any(axis=1)
    return int(np.flatnonzero(diff)[0]) + 1 if diff.any() else None


def test_lar_in_float32_keeps_the_float64_columns_as_jax_does():
    """ROADMAP check C5: on the Hilbert block of examples/zellner_gaussian.py
    at its N = 5000 (d = 100, S = 200, the GIGAO projector), LAR in float32
    takes the float64 solver's columns at each of 30 iterations, as the JAX
    package's float32 LAR does. Its restricted re-solve is ill-conditioned:
    with As^T b summed in float32 by a matrix-vector product, the port's
    columns departed at iteration 27 here (``nnls_on_support`` now sums the
    Gram and As^T b in float64 and rounds once)."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.models import gaussian

    gen = torch.Generator().manual_seed(0)
    X, Xc, Sig = bc.gen_synthetic_gaussian(gen, N=5000, d=100)
    Siginv = torch.linalg.inv(Sig)
    post = gaussian.weighted_post(torch.zeros(100, dtype=torch.float64),
                                  torch.eye(100, dtype=torch.float64), Siginv.double(),
                                  X.double(), torch.ones(5000, dtype=torch.float64))
    prj = bc.BlackBoxProjector(
        bc.prior_gaussian_sampler(post.mu.float(), torch.linalg.cholesky(post.cov.float())),
        200, model=gaussian.bundle(Siginv, float(torch.linalg.slogdet(Sig)[1])))
    A, b = (v.float() for v in (lambda s: (s.A, s.b))(
        bc.HilbertCoreset(Xc, prj, seed=0, device="cpu").snnls))
    ref = snnls.LAR(A.double(), b.double()).build_trace(30).numpy()
    got = snnls.LAR(A, b).build_trace(30).numpy()
    jax32 = np.asarray(jsnnls.LAR(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()))
                       .build_trace(30))
    assert got.dtype == np.float32 and jax32.dtype == np.float32
    assert _first_departure(jax32, ref) is None
    assert _first_departure(got, ref) is None
    assert (got[-1] > 0).sum() >= 30
