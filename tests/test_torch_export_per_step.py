"""Exported per-step-draw builds (betacores_tpu_torch/utils/export.py), on
the CPU: a sampler without a noise split draws inside the program, from the
default generator of its device, and the artifact's signature is
(data, state, itrs) -> state.

- With nothing to draw (a deterministic call sampler, every row a
  candidate and every row in the refinement), the artifact equals the live
  build bit for bit, and the JAX artifact of the same builder within the
  parity bound of tests/test_torch_incremental.py: the same selections,
  weights within 5e-3 * max(1, max|w|).
- With the NIW sampler (subsampled, full-data refinement, learn_beta), the
  artifact run after ``torch.manual_seed(s)`` twice gives one state, two
  seeds give two, the weights are finite and non-negative and m equals
  itrs; it also equals the live build drawing from the same default
  generator after the same seed (the same draws in the same order).
- It loads and runs in a fresh process that imports no model module, and
  there gives the state this process gets from the same seed."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.incremental import (IncrementalConfig as JConfig,
                                                make_incremental_builder as jbuilder)
from betacores_tpu.coresets.state import init_state as jinit_state
from betacores_tpu.models import mvn as jm
from betacores_tpu.utils import export_incremental_build as jexport
from betacores_tpu.utils import load_program as jload
from betacores_tpu_torch.coresets import IncrementalConfig, init_state, make_incremental_builder
from betacores_tpu_torch.models import mvn
from betacores_tpu_torch.utils import export_incremental_build, load_program
from test_torch_incremental import _assert_same_build, _np_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, N_SEL, N_OPT, T, ITRS, M = 32, 128, 64, 30, 5, 16


@pytest.fixture(scope="module")
def problem():
    """The contaminated NIW problem of tests/test_torch_families_build.py:
    600 rows around 2 and 60 around 12, d = 3."""
    rng = np.random.default_rng(3)
    d = 3
    X = np.vstack([rng.normal(size=(600, d)) + 2.0, rng.normal(size=(60, d)) * 0.5 + 12.0])
    prior = (np.zeros(d), 1.0, 2.0 * np.eye(d), d + 4.0)
    return X, d, prior


class _CallOnly:
    """A deterministic sampler without a noise split (the per-step-draw
    route's stand-in for the NIW sampler), for either package."""

    def __init__(self, samples):
        self.samples = samples

    def __call__(self, generator_or_key, n, wts, pts, aux):
        return self.samples[:n], aux


def _state(d, dtype=torch.float64):
    return init_state(M, d, beta=0.5, sampler_aux=torch.zeros(d + d * d, dtype=dtype),
                      dtype=dtype, device="cpu")


def test_deterministic_per_step_artifact_equals_live_and_the_jax_artifact(problem):
    """On the clean rows: the beta-likelihood projects the outliers to
    nearly one vector, so their scores tie within rounding."""
    X, d, prior = problem
    X = X[:600]
    post = mvn.mvn_niw_sampler(*(torch.tensor(np.asarray(v)) for v in prior)).posterior(
        torch.ones(600, dtype=torch.float64), torch.tensor(X))
    samples = mvn.sample_niw(torch.Generator().manual_seed(5), post, S)
    kw = dict(projection_dim=S, n_subsample_select=None, n_subsample_opt=None, opt_itrs=T,
              i0=1.0, use_beta=True, dedup_select=True)
    b = make_incremental_builder(torch.tensor(X), mvn.bundle(d), _CallOnly(samples),
                                 IncrementalConfig(**kw))
    assert b.per_step
    st0 = _state(d)
    art = load_program(export_incremental_build(b, b.data, st0))
    for itrs in (2, ITRS):
        live = b.build(st0, itrs, b.generator_draws(torch.Generator()))
        got = art(b.data, st0, torch.tensor(itrs))
        for field in live._fields:
            assert torch.equal(getattr(got, field), getattr(live, field)), (itrs, field)
    assert int(got.m) == ITRS
    jst0 = jinit_state(M, d, beta=0.5, sampler_aux=jnp.zeros(d + d * d), dtype=jnp.float64)
    jb = jbuilder(jnp.asarray(X), jm.bundle(d), _CallOnly(jnp.asarray(samples.numpy())),
                  JConfig(**kw))
    jst = jload(jexport(jb, jnp.asarray(X), jst0))(jnp.asarray(X), jax.random.key(0), jst0,
                                                  jnp.asarray(ITRS, jnp.int32))
    _assert_same_build({k: v.numpy() for k, v in got._asdict().items()}, _np_state(jst))


NIW_CASES = {"subsampled": {}, "full_data": dict(n_subsample_opt=None),
             "learn_beta": dict(learn_beta=True, i0=0.05)}


@pytest.fixture(scope="module")
def niw(problem):
    """case -> (builder, state, artifact bytes), each exported once."""
    X, d, prior = problem
    out = {}
    for name, change in NIW_CASES.items():
        kw = dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
                  opt_itrs=T, i0=1.0, use_beta=True, dedup_select=True)
        kw.update(change)
        b = make_incremental_builder(
            torch.tensor(X), mvn.bundle(d),
            mvn.mvn_niw_sampler(*(torch.tensor(np.asarray(v)) for v in prior)),
            IncrementalConfig(**kw))
        st0 = _state(d)
        out[name] = (b, st0, export_incremental_build(b, b.data, st0))
    return out


def _run(call, b, st0, seed, itrs=ITRS):
    torch.manual_seed(seed)
    return call(b.data, st0, torch.tensor(itrs))


@pytest.mark.parametrize("name", list(NIW_CASES))
def test_niw_artifact_is_reproducible_under_its_seed(niw, name):
    b, st0, data = niw[name]
    call = load_program(data)
    one, again, other = (_run(call, b, st0, s) for s in (1, 1, 2))
    for u, v in zip(one, again):
        assert torch.equal(u, v)
    assert not torch.equal(one.wts, other.wts)
    for st in (one, other):
        assert int(st.m) == ITRS
        assert bool(torch.isfinite(st.wts).all()) and bool((st.wts >= 0).all())
        assert float(st.wts.sum()) > 0
    if name == "learn_beta":
        assert float(one.beta) != float(st0.beta)
    torch.manual_seed(1)
    live = b.build(st0, ITRS, b.generator_draws(torch.default_generator))
    for u, v in zip(one, live):
        assert torch.equal(u, v)


def test_niw_artifact_loads_in_a_fresh_process_importing_no_model(niw, tmp_path):
    b, st0, data = niw["subsampled"]
    (tmp_path / "a.pt2").write_bytes(data)
    torch.save({"X": b.data, "st0": tuple(st0)}, tmp_path / "ops.pt")
    code = f"""
import sys, torch
from betacores_tpu_torch.utils.export import load_program_file
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
torch.manual_seed(7)
st = call(ops["X"], CoresetState(*ops["st0"]), torch.tensor({ITRS}))
torch.save(tuple(st), {str(tmp_path / 'st.pt')!r})
print("ok", len(mods))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = _run(load_program(data), b, st0, 7)
    for u, v in zip(torch.load(tmp_path / "st.pt"), want):
        assert torch.equal(u, v)
    # the signature has no draws operand
    with pytest.raises(Exception):
        load_program(data)(b.data, None, st0, torch.tensor(1))
