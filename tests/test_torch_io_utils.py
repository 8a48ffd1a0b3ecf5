"""The port's checkpoint, profiling and error utilities
(betacores_tpu_torch/utils/checkpoint.py, profiling.py, errors.py, prng.py)
against the JAX package's (betacores_tpu/utils/): the same status codes
and config tags, ``Timings`` artifacts under the reference's file names and
JSON keys, and checkpoints that round-trip a coreset state with its
generator, so that a build stopped after k selections, saved, loaded and
continued equals the uninterrupted build bit for bit."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import betacores_tpu.utils.checkpoint as jckpt
import betacores_tpu.utils.errors as jerrors
import betacores_tpu.utils.profiling as jprof
import betacores_tpu_torch.utils as tutils
from betacores_tpu_torch.coresets import IncrementalConfig, init_state, make_incremental_builder
from betacores_tpu_torch.inference import SHFConfig, SHFParams, init_shf_params
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg

torch.set_num_threads(1)


def test_status_codes_equal_jax():
    for name in ("STATUS_OK", "STATUS_RETRYING", "STATUS_NUMERIC_LIMIT"):
        assert getattr(tutils, name) == getattr(jerrors, name)
    assert tutils.STATUS_NAMES == jerrors.STATUS_NAMES


def test_config_tag_equals_jax():
    cfg = {"alg": "BCORES", "frate": 0.1, "d": 10, "beta": 0.5, "trial": 3}
    assert tutils.config_tag(cfg) == jckpt.config_tag(cfg) == (
        "alg_BCORES_beta_0.5_d_10_frate_0.1_trial_3")


def test_key_from_seed():
    g = tutils.key_from_seed(7, device="cpu")
    assert isinstance(g, torch.Generator) and g.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(7)))
    assert tutils.key_from_seed(g) is g


def _builder(seed=0):
    rng = np.random.default_rng(seed)
    th = rng.normal(size=4)
    X = rng.normal(size=(400, 4))
    y = np.where(X @ th + 0.3 * rng.normal(size=400) > 0, 1.0, -1.0)
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=80, n_subsample_opt=40,
                            opt_itrs=12, i0=0.5, use_beta=True)
    Z = torch.from_numpy(y[:, None] * X)
    return make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg)


def test_state_round_trip(tmp_path):
    b = _builder()
    gen = torch.Generator().manual_seed(3)
    st = b.build(init_state(8, 4, beta=0.3, dtype=torch.float64, device="cpu"), 3,
                 b.generator_draws(gen))
    path = str(tmp_path / "st.pt")
    extra = {"itrs": 3, "tag": "bcores", "trace": np.arange(3.0), "nested": {"n": [1, 2]}}
    tutils.save_state(path, st, gen, extra)
    st2, gen2, extra2 = tutils.load_state(path, device="cpu")
    for a, c in zip(st, st2):
        assert a.dtype == c.dtype and torch.equal(a, c)
    assert torch.equal(gen2.get_state(), gen.get_state())
    assert extra2["itrs"] == 3 and extra2["tag"] == "bcores" and extra2["nested"] == {"n": [1, 2]}
    assert torch.equal(extra2["trace"], torch.arange(3.0, dtype=torch.float64))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    tutils.save_state(path, st)                     # overwrites; no generator
    assert tutils.load_state(path, device="cpu")[1:] == (None, {})


def test_a_saved_and_continued_build_equals_the_uninterrupted_one(tmp_path):
    """3 selections, saved with the generator and loaded, then 3 more, in a
    builder of its own: the uninterrupted 6-selection build, bit for bit."""
    st0 = init_state(8, 4, beta=0.3, dtype=torch.float64, device="cpu")
    b = _builder()
    want = b.build(st0, 6, b.generator_draws(torch.Generator().manual_seed(5)))
    gen = torch.Generator().manual_seed(5)
    half = b.build(st0, 3, b.generator_draws(gen))
    path = str(tmp_path / "half.pt")
    tutils.save_state(path, half, gen, {"done": 3})
    st, gen2, extra = tutils.load_state(path, device="cpu")
    b2 = _builder()
    got = b2.build(st, 6 - extra["done"], b2.generator_draws(gen2))
    assert int(got.m) >= 4
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_save_params_round_trips_shf_parameters(tmp_path):
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 3)))
    params = init_shf_params(pts, 3, 100, SHFConfig(n_blocks=2))
    path = str(tmp_path / "flow.pt")
    tutils.save_params(path, params, {"steps": 20})
    got, extra = tutils.load_params(path, SHFParams, device="cpu")
    assert isinstance(got, SHFParams) and extra == {"steps": 20}
    for a, c in zip(params, got):
        assert torch.equal(a, c)


def test_timings_artifacts_match_jax(tmp_path):
    """The same sections give the reference's ``<prefix>_<name>_time.npy``
    files and ``<prefix>_timings.json`` with its keys; ``hold`` returns
    what it is given."""
    tj, tt = jprof.Timings(), tutils.Timings()
    for _ in range(2):
        for name in ("leaf", "final"):
            with tj.section(name) as s:
                s.hold(jax.numpy.ones(3))
            with tt.section(name) as s:
                x = torch.ones(3)
                assert s.hold(x) is x and s.hold(x, x) == (x, x)
    tj.save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path))
    assert [f[len("port"):] for f in files if f.startswith("port")] == [
        f[len("jax"):] for f in files if f.startswith("jax")]
    assert "port_leaf_time.npy" in files and "port_timings.json" in files
    with open(tmp_path / "jax_timings.json") as f, open(tmp_path / "port_timings.json") as g:
        jj, pp = json.load(f), json.load(g)
    assert {k: sorted(v) for k, v in jj.items()} == {k: sorted(v) for k, v in pp.items()}
    assert pp["leaf"]["n"] == 2 and np.load(tmp_path / "port_leaf_time.npy").shape == (2,)
    assert tt.total("leaf") == pytest.approx(pp["leaf"]["total_s"])
    assert tt.summary().startswith("leaf: ")


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tutils.trace(str(logdir)) as prof:
        with tutils.annotate("streaming.leaf"):
            torch.ones(64).sum()
    traces = os.listdir(logdir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(logdir / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "streaming.leaf" for e in events)
    assert any(e.key == "streaming.leaf" for e in prof.key_averages())
    with tutils.trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not (tmp_path / "off").exists()
