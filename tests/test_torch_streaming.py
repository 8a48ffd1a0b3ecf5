"""The port's merge-reduce build (betacores_tpu_torch/coresets/streaming.py)
against the JAX package's (betacores_tpu/coresets/streaming.py), on the CPU
in float64.

The two packages' random streams cannot match, so the port is fed the JAX
build's own draws through its ``draws`` seam: the JAX build splits its key
into K leaf keys and a final key, and each reduction level's group keys
fold 1000 + level into the final key; ``jax_stream_draws`` rebuilds every
build's draws from those keys with ``replay_jax_draws``
(tests/test_torch_incremental.py). Under them the leaf union's rows are the
JAX rows exactly, the final ``idcs`` the JAX ones, and every weight within
1e-6 max|w| of the JAX weight.

The rest holds the port against itself under its own per-(stage, index)
generators: the batched leaf pass and the mesh-streamed pass (a gloo world
of two ranks, tests/torch_dist_worker.py) give the streamed pass's bits, one
builder serves two different chunks, and a crashed run resumes from its
checkpoint to the uninterrupted run's bits (the reference's
test_checkpoint_resume_bit_identical and
test_reduction_checkpoint_resume_bit_identical)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import betacores_tpu_torch.coresets.streaming as streaming
from betacores_tpu.coresets.incremental import IncrementalConfig as JConfig
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.coresets.streaming import merge_reduce_build as jmerge_reduce_build
from betacores_tpu.inference.samplers import (gaussian_conjugate_sampler as jgauss_sampler,
                                              logreg_laplace_sampler as jlogreg_sampler)
from betacores_tpu.models import gaussian as jg
from betacores_tpu.models import logreg as jlr
from betacores_tpu_torch.coresets import (IncrementalConfig, make_incremental_builder,
                                         merge_reduce_build, state_from_numpy)
from betacores_tpu_torch.inference import gaussian_conjugate_sampler, logreg_laplace_sampler
from betacores_tpu_torch.models import gaussian as tg
from betacores_tpu_torch.models import logreg as tlr
from test_torch_incremental import replay_jax_draws
from torch_dist_worker import run_world

torch.set_num_threads(1)

D, CHUNK, M_BUF, M_LEAF, M_FINAL = 3, 90, 8, 5, 6
N = 4 * CHUNK - 30                      # K = 4 leaves, the last a 60-row tail chunk
LEAF = dict(projection_dim=16, n_subsample_select=60, n_subsample_opt=40, opt_itrs=15,
            i0=1.0, use_beta=True)
# the weighted final build over every union row, as examples/streaming_build.py's
# (examples/streaming_outofcore.py's final build is subsampled as its leaves are)
FINAL = dict(projection_dim=16, n_subsample_select=None, n_subsample_opt=None, opt_itrs=15,
             i0=1.0, use_beta=True)


def _gauss_data():
    """A contaminated Gaussian: clean rows around 1, a tenth shifted to 9."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, D)) + 1.0
    out = rng.choice(N, N // 10, replace=False)
    X[out] = rng.normal(size=(len(out), D)) * 2.0 + 9.0
    return X


def _logreg_data():
    """Well-separated logistic rows z = y x (tests/test_torch_incremental.py's recipe)."""
    rng = np.random.default_rng(42)
    th = rng.normal(size=D)
    X = rng.normal(size=(N, D))
    y = np.where(X @ th + 0.3 * rng.normal(size=N) > 0, 1.0, -1.0)
    return y[:, None] * X


def _problem(kind):
    """(data, JAX model, JAX sampler, port model, port sampler, worker spec)."""
    if kind == "gaussian":
        Siginv, logdet = np.eye(D) / 2.0, float(D * np.log(2.0))
        prior = (np.zeros(D), np.eye(D), Siginv)
        return (_gauss_data(), jg.bundle(jnp.asarray(Siginv), logdet),
                jgauss_sampler(*map(jnp.asarray, prior)),
                tg.bundle(torch.from_numpy(Siginv), logdet),
                gaussian_conjugate_sampler(*map(torch.from_numpy, prior)),
                ("gaussian", *prior, logdet))
    return (_logreg_data(), jlr.bundle(), jlogreg_sampler(), tlr.bundle(),
            logreg_laplace_sampler(), "logreg")


def _jax_leaf_state():
    return jinit_state(M_BUF, D, beta=0.4, sampler_aux=jnp.zeros(D), dtype=jnp.float64)


def _leaf_state():
    return state_from_numpy({k: np.asarray(v) for k, v in _jax_leaf_state()._asdict().items()},
                            device="cpu")


def jax_stream_draws(key, jsmp, K, final=FINAL, max_union_rows=None):
    """``draws(stage, index)`` giving the port every build's draws of the
    JAX ``merge_reduce_build(key, ...)`` of this file's configuration, with
    the final build's configuration ``final``."""
    keys = jax.random.split(key, K + 1)
    st_leaf = _jax_leaf_state()
    st_final = jinit_state(M_FINAL, D, beta=0.4, sampler_aux=jnp.zeros(D), dtype=jnp.float64)

    def replay(k, st, itrs, n_rows, cfg):
        cap = lambda n: None if n is None else min(n_rows, n)
        return replay_jax_draws(k, st, itrs, jsmp, n_rows, cfg["projection_dim"],
                                cfg["opt_itrs"], cap(cfg["n_subsample_select"]),
                                cap(cfg["n_subsample_opt"]))

    rows, groups = K * M_BUF, []       # each reduction level's group count
    while max_union_rows is not None and rows > max_union_rows:
        groups.append(math.ceil(rows / max_union_rows))
        rows = groups[-1] * M_BUF

    def draws(stage, index):
        if stage == "leaf":
            return replay(keys[index], st_leaf, M_LEAF, CHUNK, LEAF)
        if stage == "final":
            return replay(keys[K], st_final, M_FINAL, rows, final)
        level = stage[1]
        k = jax.random.split(jax.random.fold_in(keys[K], 1000 + level), groups[level])[index]
        return replay(k, st_leaf, M_LEAF, max_union_rows, LEAF)

    return draws


@pytest.mark.parametrize("kind, final, max_union_rows", [("gaussian", "subsampled", None),
                                                         ("logreg", "full", None),
                                                         ("gaussian", "subsampled", 2 * M_BUF)])
def test_merge_reduce_matches_jax_under_its_draws(kind, final, max_union_rows):
    """K = 4 leaves with a tail chunk, then the weighted final build, over
    every union row or subsampled (and with ``max_union_rows`` one reduction
    level of two groups): the union's rows are the JAX rows, the final idcs
    the JAX idcs, and the weights within 1e-6 max|w|."""
    X, jmodel, jsmp, tmodel, tsmp, _ = _problem(kind)
    fin = FINAL if final == "full" else LEAF
    key = jax.random.key(2)
    jst, jpts, jwts = jmerge_reduce_build(
        key, jnp.asarray(X), jmodel, jsmp, JConfig(**LEAF), JConfig(**fin), CHUNK, M_LEAF,
        M_FINAL, _jax_leaf_state(), max_union_rows=max_union_rows)
    st, pts, wts = merge_reduce_build(
        2, X, tmodel, tsmp, IncrementalConfig(**LEAF), IncrementalConfig(**fin), CHUNK,
        M_LEAF, M_FINAL, _leaf_state(), max_union_rows=max_union_rows,
        draws=jax_stream_draws(key, jsmp, 4, fin, max_union_rows), device="cpu")
    rows = 4 * M_BUF if max_union_rows is None else max_union_rows
    assert pts.shape == (rows, D) and wts.shape == (rows,)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    jw = np.asarray(jwts)
    assert (jw > 0).sum() >= 4
    np.testing.assert_allclose(wts.numpy(), jw, rtol=0, atol=1e-6 * np.abs(jw).max())
    assert int(st.m) == int(jst.m) >= 2
    np.testing.assert_array_equal(st.idcs.numpy(), np.asarray(jst.idcs))
    np.testing.assert_array_equal(st.pts.numpy(), np.asarray(jst.pts))
    fw = np.asarray(jst.wts)
    np.testing.assert_allclose(st.wts.numpy(), fw, rtol=0, atol=1e-6 * np.abs(fw).max())


def _port_args(kind="gaussian"):
    X, _, _, tmodel, tsmp, spec = _problem(kind)
    return X, dict(model=tmodel, sampler=tsmp, leaf_config=IncrementalConfig(**LEAF),
                   final_config=IncrementalConfig(**FINAL), chunk_size=CHUNK,
                   m_leaf=M_LEAF, m_final=M_FINAL, st_leaf=_leaf_state(), device="cpu"), spec


def _assert_bits(a, b):
    """Two (state, leaf_pts, leaf_wts) results agree bit for bit."""
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        assert torch.equal(x, y)


def test_parallel_leaves_equal_the_streamed_pass_bit_for_bit():
    X, args, _ = _port_args("logreg")
    _assert_bits(merge_reduce_build(3, X, parallel_leaves=True, **args),
                 merge_reduce_build(3, X, **args))


def test_one_builder_serves_two_chunks():
    """A builder over one chunk's buffer, refilled with another chunk, builds
    what a fresh builder over that chunk builds: the pass reads the new
    rows."""
    X, args, _ = _port_args("logreg")
    cfg = args["leaf_config"]
    a, b = (torch.from_numpy(X[i * CHUNK:(i + 1) * CHUNK]).clone() for i in (0, 1))
    u = torch.ones(CHUNK, dtype=torch.float64)
    gen = lambda bld: bld.generator_draws(torch.Generator().manual_seed(4))
    reused = make_incremental_builder(a, args["model"], args["sampler"], cfg, data_weights=u)
    reused.build_with_data(a, u, args["st_leaf"], M_LEAF, gen(reused))
    got = reused.build_with_data(b, u, args["st_leaf"], M_LEAF, gen(reused))
    fresh = make_incremental_builder(b, args["model"], args["sampler"], cfg, data_weights=u)
    want = fresh.build(args["st_leaf"], M_LEAF, gen(fresh))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _crash_after(monkeypatch, n_builds):
    """Makes every builder's ``build_with_data`` raise once ``n_builds``
    leaf or group builds have run."""
    orig = streaming.make_incremental_builder
    calls = {"n": 0}

    def crashing(*a, **k):
        b = orig(*a, **k)
        inner = b.build_with_data

        def bwd(*aa, **kk):
            if calls["n"] == n_builds:
                raise RuntimeError("simulated crash")
            calls["n"] += 1
            return inner(*aa, **kk)

        b.build_with_data = bwd
        return b

    monkeypatch.setattr(streaming, "make_incremental_builder", crashing)


def test_checkpoint_resume_bit_identical(tmp_path, monkeypatch):
    """A crash after 2 of 4 leaves, a rerun with the same arguments: the
    resumed result is the uninterrupted one bit for bit and the checkpoint
    is removed; another seed or another shape is refused."""
    X, args, _ = _port_args()
    ref = merge_reduce_build(3, X, **args)
    ck = str(tmp_path / "mr.npz")
    with monkeypatch.context() as mp:
        _crash_after(mp, 2)
        with pytest.raises(RuntimeError, match="simulated crash"):
            merge_reduce_build(3, X, checkpoint_path=ck, **args)
    with np.load(ck) as z:
        assert int(z["n_done"]) == 2 and np.array_equal(z["key_fp"], [3])
        assert set(z.files) == {"key_fp", "n_done", "wts", "pts"}
    with pytest.raises(ValueError, match="different"):
        merge_reduce_build(99, X, checkpoint_path=ck, **args)
    with pytest.raises(ValueError, match="does not match"):
        merge_reduce_build(3, X, checkpoint_path=ck, **dict(args, chunk_size=CHUNK + 30))
    _assert_bits(merge_reduce_build(3, X, checkpoint_path=ck, **args), ref)
    assert not os.path.exists(ck)


def test_reduction_checkpoint_resume_bit_identical(tmp_path, monkeypatch):
    """With ``max_union_rows`` = 2 M_buf the 32-row union reduces in two
    groups: a crash in the second group (after 4 leaves and 1 group)
    resumes at that group, bit-identical to the uninterrupted run."""
    X, args, _ = _port_args()
    args["max_union_rows"] = 2 * M_BUF
    ref = merge_reduce_build(3, X, **args)
    ck = str(tmp_path / "mr.npz")
    with monkeypatch.context() as mp:
        _crash_after(mp, 5)
        with pytest.raises(RuntimeError, match="simulated crash"):
            merge_reduce_build(3, X, checkpoint_path=ck, **args)
    with np.load(ck) as z:
        assert int(z["n_done"]) == 4 and int(z["red_level"]) == 0
        assert int(z["red_g_done"]) == 1
    _assert_bits(merge_reduce_build(3, X, checkpoint_path=ck, **args), ref)
    assert not os.path.exists(ck)
    with pytest.raises(ValueError, match="max_union_rows"):
        merge_reduce_build(3, X, **dict(args, max_union_rows=M_BUF))


def test_checkpoint_needs_the_streamed_pass(tmp_path):
    X, args, _ = _port_args()
    ck = str(tmp_path / "mr.npz")
    with pytest.raises(ValueError, match="streamed leaf pass"):
        merge_reduce_build(3, X, checkpoint_path=ck, parallel_leaves=True, **args)
    with pytest.raises(ValueError, match="streamed leaf pass"):
        merge_reduce_build(3, X, checkpoint_path=ck, mesh=object(), **args)
    assert not os.path.exists(ck)


def test_streaming_runs_on_the_card_unless_asked(monkeypatch):
    X, args, _ = _port_args()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        merge_reduce_build(3, X, **dict(args, device=None))


def test_mesh_leaf_pass_equals_the_streamed_pass(tmp_path):
    """Two ranks over 5 leaves (a 40-row tail): 3 rounds, the last with a
    pad lane. Every rank returns the single-process streamed result bit for
    bit, with one all_gather a round."""
    X, args, spec = _port_args()
    X = np.concatenate([X, X[:5 * CHUNK - 50 - N] + 0.5])
    job = dict(kind="stream", seed=3, data=X, model=spec, leaf_cfg=LEAF, final_cfg=FINAL,
               chunk=CHUNK, m_leaf=M_LEAF, m_final=M_FINAL,
               state={k: v.numpy() for k, v in args["st_leaf"]._asdict().items()})
    ranks = run_world(2, 1, {"stream": job}, tmp_path)
    want = merge_reduce_build(3, X, **args)
    for r in ranks:
        got = r["jobs"]["stream"]
        assert got["calls"] == {"all_gather": 3}
        assert got["leaf_wts"].shape == (5 * M_BUF,)
        np.testing.assert_array_equal(got["leaf_wts"], want[2].numpy())
        np.testing.assert_array_equal(got["leaf_pts"], want[1].numpy())
        for k, v in got["state"].items():
            np.testing.assert_array_equal(v, getattr(want[0], k).numpy())
