"""The port's entry points (betacores_tpu_torch/entry.py) against
__graft_entry__.py, and its mesh driver (examples/virtual_mesh_headline.py)
on gloo worlds, on the CPU.

``entry()``'s iteration, rebuilt over the JAX ``_problem``'s rows and fed
the JAX build's draws (tests/test_torch_incremental.py::replay_jax_draws),
selects the JAX index with weights within 5e-3 max|w|. ``dryrun_multichip``
runs in a fresh process, as tests/test_entry.py runs the JAX one: asked
for the CPU it spawns gloo ranks there and says so on its last line; asked
for the card (its default) with fewer cards than ranks, it raises. The
mesh driver's worlds are spawned gloo processes; its census must equal the design's counts (its docstring). A mesh larger than the
machine's cards, asked of the card, raises and names the count; no driver
moves to the CPU unless asked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_examples import ROOT, _run_jax, _run_port
from test_torch_incremental import _np_state, replay_jax_draws


def _fresh_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH", "JAX_PLATFORMS", "_BETACORES_DRYRUN_SMOKE")}
    env["PYTHONPATH"] = ROOT
    env.update(extra)
    return env


def test_entry_iteration_selects_the_jax_index_under_the_jax_draws():
    import __graft_entry__ as g
    from betacores_tpu.inference.samplers import logreg_laplace_sampler as jsampler
    from betacores_tpu_torch import entry as port
    from betacores_tpu_torch.coresets import state_from_numpy, state_to_numpy

    fn, (key, st0) = g.entry()
    jst = fn(key, st0)
    Z, _, _ = g._problem(port.N_ROWS, port.D_FEAT)
    assert Z.shape == (port.N_ROWS, port.D_FEAT) and st0.wts.shape == (port.SLOTS,)
    builder = port.make_entry_builder(torch.from_numpy(np.array(Z)))
    draws = replay_jax_draws(key, st0, 1, jsampler(), port.N_ROWS, port.S, port.OPT_ITRS,
                             port.N_SEL, port.N_OPT)
    got = state_to_numpy(builder.build(state_from_numpy(_np_state(st0), device="cpu"), 1,
                                       draws))
    want = _np_state(jst)
    assert int(got["m"]) == int(want["m"]) == 1
    np.testing.assert_array_equal(got["idcs"], want["idcs"])
    np.testing.assert_array_equal(got["pts"], want["pts"])
    w0 = want["wts"]
    np.testing.assert_allclose(got["wts"], w0, atol=5e-3 * np.abs(w0).max())


def test_entry_on_the_cpu_takes_a_generator_or_draws():
    from betacores_tpu_torch import entry as port

    fn, (gen, st) = port.entry("cpu")
    out = fn(gen, st)
    assert int(out.m) == 1 and st.wts.shape == (port.SLOTS,)
    assert torch.isfinite(out.wts).all() and float(out.wts.sum()) > 0
    # the same iteration again from the example's seed: the same coreset
    again = fn(torch.Generator().manual_seed(1), st)
    assert torch.equal(again.idcs, out.idcs) and torch.equal(again.wts, out.wts)
    assert fn.builder.fstep is not None       # K1's route: the fused step


def test_dryrun_multichip_spawns_gloo_ranks_in_a_fresh_process():
    """dryrun_multichip(4, device="cpu") in a fresh process: four gloo ranks
    on a (2, 2) mesh, smoke mode, no JAX imported."""
    code = ("import sys\n"
            "from betacores_tpu_torch.entry import dryrun_multichip\n"
            "rec = dryrun_multichip(4, device='cpu')\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'betacores_tpu')]\n"
            "print('BOOTSTRAP_OK', rec['subsystems'])\n")
    r = subprocess.run([sys.executable, "-c", code], env=_fresh_env(_BETACORES_DRYRUN_SMOKE="1"),
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-2] == ("dryrun_multichip ok: platform cpu, 4 ranks over gloo, smoke mode, "
                         "subsystems sharded build, weighted sharded build")
    assert lines[-1].startswith("BOOTSTRAP_OK")


def test_dryrun_multichip_runs_every_subsystem():
    """The whole dry run, every subsystem in the reference's order, on two
    gloo ranks."""
    code = ("from betacores_tpu_torch.entry import dryrun_multichip\n"
            "dryrun_multichip(2, device='cpu')\n")
    r = subprocess.run([sys.executable, "-c", code], env=_fresh_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == (
        "dryrun_multichip ok: platform cpu, 2 ranks over gloo, subsystems sharded build, "
        "weighted sharded build, full-data full-gradient sharded build, sharded Hilbert, "
        "sharded BPSVI lanes, sharded group build, sharded flow trainer, mesh merge-reduce "
        "build, sharded HMC chains")


MESH = ["--itrs", "3", "--n", "2000", "--proj-dim", "16", "--opt-itrs", "10",
        "--n-subsample-select", "120", "--n-subsample-opt", "60"]


@pytest.mark.parametrize("mesh", ["4x2", "2x2"])
def test_virtual_mesh_headline_on_gloo(mesh, capsys, monkeypatch):
    """The JAX test's arguments on a gloo world of D*S ranks: ok=True,
    distinct indices, and the census's counts and the build's collectives
    are the design's."""
    from betacores_tpu_torch.examples.virtual_mesh_headline import CENSUS

    rec = _run_port("virtual_mesh_headline", ["--mesh", mesh, "--census"] + MESH)
    out = capsys.readouterr().out
    d, s = mesh.split("x")
    # a selection may pick a point already in the coreset (it then moves its
    # weight, as the reference's does), so m is at most the selections
    m = rec["m"]
    assert rec["ok"] and 1 <= m <= 3 and rec["route"] == "fused"
    assert len(set(rec["idcs"][:m].tolist())) == m
    assert f"[headline] mesh={{'data': {d}, 'samp': {s}}} N=2000 M=3 S=16 opt_itrs=10: " \
           f"selected m={m}" in out and "ok=True" in out
    assert rec["census"] == CENSUS["headline"] and "equal" in out
    # the build's own collectives: the census's per select and per step
    (sel, step) = CENSUS["headline"]
    assert rec["calls"] == {"psum": 3 * (sel["psum"] + 10 * step["psum"]),
                            "all_gather": 3 * sel["all_gather"]}
    if mesh == "4x2":
        _run_jax("virtual_mesh_headline.py", ["--mesh", mesh] + MESH, monkeypatch)
        jax_out = capsys.readouterr().out
        head = "[headline] mesh={'data': 4, 'samp': 2} N=2000 M=3 S=16 opt_itrs=10: selected m="
        assert head in jax_out and head in out


@pytest.mark.parametrize("mode", ["--full-data", "--full-gradient"])
def test_virtual_mesh_headline_full_modes_census(mode, capsys):
    from betacores_tpu_torch.examples.virtual_mesh_headline import CENSUS

    rec = _run_port("virtual_mesh_headline", ["--mesh", "2x1", "--census", mode] + MESH)
    name = "full-gradient" if mode == "--full-gradient" else "full-select"
    assert rec["ok"] and 1 <= rec["m"] <= 3 and rec["census"] == CENSUS[name]
    assert f"[{name}] collective census" in capsys.readouterr().out


def test_the_card_is_never_left_for_the_cpu_unasked():
    """Without a card every driver that defaults to it raises (none moves
    to the CPU), and a mesh past the card count raises naming the count."""
    from betacores_tpu_torch import entry as port
    from betacores_tpu_torch.examples import dp_bpsvi, virtual_mesh_headline
    from betacores_tpu_torch.parallel import world_backend

    assert not torch.cuda.is_available()
    with pytest.raises(ValueError, match=r"a mesh of 8 ranks on cards needs 8 cards, this "
                                         r"machine has 0"):
        virtual_mesh_headline.main(MESH)
    with pytest.raises(ValueError, match="needs 2 cards, this machine has 0"):
        world_backend("cuda", 2)
    assert world_backend("cpu", 8) == "gloo"
    with pytest.raises((RuntimeError, AssertionError)):
        dp_bpsvi.main(["--N", "50", "--d", "2", "--M", "2", "--noise-grid", "1.0"])
    with pytest.raises((RuntimeError, AssertionError)):
        port.entry()
    with pytest.raises(ValueError, match="needs 1 cards, this machine has 0"):
        port.dryrun_multichip(1)


def test_entry_module_runs_as_a_script():
    r = subprocess.run([sys.executable, "-m", "betacores_tpu_torch.entry", "--device", "cpu",
                        "--n", "1"], env=_fresh_env(_BETACORES_DRYRUN_SMOKE="1"), cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "entry ok; m = 1" in r.stdout and "platform cpu, 1 ranks over gloo" in r.stdout

