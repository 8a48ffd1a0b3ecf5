"""The port's experiment drivers (betacores_tpu_torch/examples/) against the
JAX package's (examples/): each runs in-process on the CPU at the tiny
arguments of its JAX test in tests/test_examples.py, and so does the JAX
driver; both must write the same results-file name and the same pickle
keys, with finite values laid out alike (the same shapes; a coreset's
support, whose size follows the draws, only in its trailing dimensions).
The sweep and plotting tools run on the port's pickles, and the port's
``config.linearize`` against the JAX one."""

import os
import pickle
import runpy
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _run_jax(script, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")


def _run_port(name, argv):
    import importlib

    return importlib.import_module(f"betacores_tpu_torch.examples.{name}").main(
        argv + ["--device", "cpu"])


def _pickles(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pk"))


# keys whose values hold one coreset per size: the support's size follows
# the draws, so only the trailing dimensions must agree
SUPPORT_KEYS = ("w", "p")
# the flags the port adds to every driver
PORT_FLAGS = {"device", "seed"}


def _assert_same_layout(got, want, path="", support=False):
    """``got`` (the port's pickle) is laid out as ``want`` (the JAX one):
    the same dict keys (a driver's ``args`` plus the port's flags), list
    lengths and array shapes, and finite numbers wherever JAX's are."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        keys = set(got) - (PORT_FLAGS if path.endswith("args") else set())
        assert keys == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_same_layout(got[k], want[k], f"{path}.{k}", k in SUPPORT_KEYS)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_layout(g, w, f"{path}[{i}]", support)
    elif isinstance(want, (np.ndarray, np.generic)) and np.asarray(want).dtype != object:
        g, w = np.asarray(got), np.asarray(want)
        shape = (lambda a: a.shape[1:]) if support else (lambda a: a.shape)
        assert g.ndim == w.ndim and shape(g) == shape(w), (path, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.number) and np.isfinite(w).all():
            assert np.isfinite(g).all(), path
    elif isinstance(want, float):
        assert isinstance(got, (float, np.floating)), path
        if np.isfinite(want):
            assert np.isfinite(got), path
    elif want is None or isinstance(want, (bool, int, str)):
        assert type(got) is type(want) or path.endswith(tuple(f".{k}" for k in PORT_FLAGS)), \
            (path, got, want)


TINY = {
    "zellner_logreg": (["--alg", "BCORES", "--dataset", "synth_lr_tiny_missing", "--M", "3",
                        "--proj-dim", "8", "--opt-itrs", "5", "--n-subsample-opt", "50",
                        "--n-subsample-select", "100", "--eval-every", "2",
                        "--mcmc-samples", "20", "--mcmc-warmup", "20"]),
    "zellner_neural_linear": (["--alg", "BCORES", "--M", "2", "--N", "200", "--D", "4",
                               "--batch-size", "10", "--init-size", "10",
                               "--out-features", "8", "--proj-dim", "8", "--opt-itrs", "5",
                               "--n-subsample-opt", "50", "--nn-epochs", "3"]),
    "group_selection": (["--alg", "BCORES", "--M", "2", "--proj-dim", "8", "--opt-itrs", "5",
                         "--n-subsample-opt", "100"]),
    "poisson_regression": (["--alg", "BCORES", "--dataset", "synth_missing", "--M", "3",
                            "--proj-dim", "8", "--opt-itrs", "5", "--n-subsample-opt", "50",
                            "--n-subsample-select", "100", "--eval-every", "2"]),
    "multiclass": (["--alg", "BCORES", "--K", "3", "--d", "3", "--N", "400",
                    "--N-test", "400", "--M", "8", "--proj-dim", "12", "--opt-itrs", "10",
                    "--n-subsample-opt", "60", "--n-subsample-select", "120",
                    "--eval-every", "4"]),
}
GAUSS = ["--trial", "1", "--M", "3", "--N", "200", "--d", "4", "--proj-dim", "8",
         "--opt-itrs", "5", "--n-subsample-opt", "50", "--n-subsample-select", "100"]
MVN = ["--trial", "1", "--N", "200", "--d", "3", "--M", "6", "--proj-dim", "8",
       "--opt-itrs", "10", "--n-subsample-opt", "50", "--n-subsample-select", "80",
       "--eval-every", "3"]
CASES = ([(name, argv) for name, argv in TINY.items()]
         + [("zellner_gaussian", ["--alg", alg] + GAUSS)
            for alg in ("BCORES", "BPSVI", "GIGAO", "IHTO", "RAND", "PRIOR")]
         + [("zellner_gaussian", ["--alg", "BCORES", "--select-beta", "--beta-grid", "0.1,0.5",
                                  "--select-M", "2"] + GAUSS)]
         + [("mvn_unknown_cov", ["--alg", alg] + MVN) for alg in ("BCORES", "RAND")]
         + [("mvn_unknown_cov", ["--alg", "BCORES", "--select-beta", "--beta-grid", "0.1,0.7",
                                 "--select-M", "3"] + MVN)]
         + [("group_selection", TINY["group_selection"][:1] + [alg]
             + TINY["group_selection"][2:]) for alg in ("RAND", "DShapley", "TMC")]
         + [("group_selection", TINY["group_selection"]
             + ["--select-beta", "--beta-grid", "0.1,0.5", "--select-M", "2"])])


@pytest.mark.parametrize("name,argv", CASES,
                         ids=[f"{n}-{a[1]}-{i}" for i, (n, a) in enumerate(CASES)])
def test_driver_writes_the_jax_drivers_results(tmp_path, monkeypatch, name, argv):
    d_port, d_jax = tmp_path / "port", tmp_path / "jax"
    out = _run_port(name, argv + ["--results-dir", str(d_port)])
    _run_jax(f"{name}.py", argv + ["--results-dir", str(d_jax)], monkeypatch)
    (f,) = _pickles(d_jax)
    assert _pickles(d_port) == [f] and os.path.basename(out) == f
    with open(d_port / f, "rb") as fh:
        got = pickle.load(fh)
    with open(d_jax / f, "rb") as fh:
        want = pickle.load(fh)
    _assert_same_layout(got, want)


def test_shf_driver_prints_the_jax_drivers_lines(capsys, monkeypatch):
    """The flow driver writes no file: both print the flow's line, the HMC
    baseline's and the mean gap, and the port's numbers are finite."""
    argv = ["--N", "160", "--d", "3", "--M", "6", "--blocks", "2", "--leapfrog", "2",
            "--train-steps", "20", "--chunk", "20", "--n-samples", "40"]
    rec = _run_port("shf_logreg", argv)
    port_out = capsys.readouterr().out
    _run_jax("shf_logreg.py", argv, monkeypatch)
    jax_out = capsys.readouterr().out
    for line in ("SHF :", "HMC :", "posterior mean gap"):
        assert line in port_out and line in jax_out
    assert all(np.isfinite(v) for v in rec.values())
    assert rec["acc_flow"] > 0.6 and rec["acc_hmc"] > 0.6


def test_run_sweep_list(capsys):
    from betacores_tpu_torch.examples import run_sweep

    run_sweep.main(["--exp", "logreg", "--list"])
    out = capsys.readouterr().out
    assert "BCORES" in out and "--graddiag" in out and "--i0" in out


def test_run_sweep_boolean_flag_convention(monkeypatch):
    """None omits the flag, '' passes it bare; each grid point runs the
    port's driver with ``python -m``."""
    import subprocess

    from betacores_tpu_torch.examples import run_sweep

    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: (
        calls.append(cmd) or type("R", (), {"returncode": 0})()))
    run_sweep.main(["--exp", "logreg_i0_graddiag"])
    assert len(calls) == 6  # 2 graddiag x 3 i0
    assert all(c[1:3] == ["-m", "betacores_tpu_torch.examples.zellner_logreg"]
               for c in calls)
    with_flag = [c for c in calls if "--graddiag" in c]
    assert len(with_flag) == 3
    for c in with_flag:
        assert c[c.index("--graddiag") + 1].startswith("--")


def test_run_sweep_runs_a_grid_point(tmp_path):
    """One grid point with --index, through a real subprocess of the port's
    driver on the CPU."""
    from betacores_tpu_torch.examples import run_sweep

    run_sweep.main(["--exp", "gaussian", "--index", "0", "--results-dir", str(tmp_path),
                    "--", "--device", "cpu"] + GAUSS[2:])
    assert _pickles(tmp_path) == ["results_BCORES_1_b0.1.pk"]


def test_linearize_matches_jax():
    from betacores_tpu.config import linearize as jlinearize
    from betacores_tpu_torch.config import linearize
    from betacores_tpu_torch.examples.run_sweep import GRIDS

    for spec in GRIDS.values():
        assert linearize(spec["grid"]) == jlinearize(spec["grid"])
    assert linearize({"a": [1, 2], "b": ["x", None, ""]})[4] == {"a": 2, "b": None}


def test_median_iqr_matches_jax():
    from betacores_tpu.plotting import median_iqr as jmedian_iqr
    from betacores_tpu_torch.plotting import median_iqr

    arr = np.random.default_rng(0).normal(size=(7, 5))
    for got, want in zip(median_iqr(arr), jmedian_iqr(arr)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """The port's own pickles of three kinds, two trials each."""
    d = tmp_path_factory.mktemp("port_results")
    for trial in ("1", "2"):
        _run_port("zellner_gaussian", ["--alg", "BCORES", "--trial", trial] + GAUSS[2:]
                  + ["--results-dir", str(d / "gaussian")])
        _run_port("poisson_regression", TINY["poisson_regression"]
                  + ["--trial", trial, "--results-dir", str(d / "poisson")])
        _run_port("group_selection", TINY["group_selection"]
                  + ["--trial", trial, "--results-dir", str(d / "groups")])
    return d


@pytest.mark.parametrize("kind", ["gaussian", "poisson", "groups"])
def test_plot_results_on_the_ports_pickles(port_results, tmp_path, kind):
    from betacores_tpu_torch.examples import plot_results

    out = tmp_path / f"{kind}.png"
    assert plot_results.main(["--kind", kind, "--results-dir", str(port_results / kind),
                              "--out", str(out)]) == str(out)
    assert out.exists() and out.stat().st_size > 0


def test_plot_results_logreg_modal_config_reads_missing_keys_as_defaults(tmp_path, capsys):
    """A pickle written before a swept flag existed counts as that flag's
    default, so it bands with the new runs at the default (the JAX tool
    keys it as None and drops it)."""
    from betacores_tpu_torch.examples import plot_results

    for t, args in ((1, {"alg": "BCORES"}),
                    (2, {"alg": "BCORES", "i0": 1.0, "f_rate": 0.1, "beta": 0.1,
                         "graddiag": False, "dedup_select": False})):
        with open(tmp_path / f"results_lr_{t}.pk", "wb") as f:
            pickle.dump({"args": args, "accs": {1: 0.6, 5: 0.7, 10: 0.72 + 0.01 * t},
                         "plls": {1: -0.9, 5: -0.7, 10: -0.6}}, f)
    out = tmp_path / "lr.png"
    plot_results.main(["--kind", "logreg", "--results-dir", str(tmp_path), "--out", str(out)])
    printed = capsys.readouterr().out
    assert "WARNING" not in printed and "'BCORES': (2, 3)" in printed


def test_drivers_import_no_jax_and_no_matplotlib():
    """Every ported driver, the entry points, the plotting kit and the export
    import neither JAX nor the JAX package, and nothing imports matplotlib
    until a figure is drawn (the card's machine may lack it)."""
    import subprocess

    mods = ["betacores_tpu_torch.config", "betacores_tpu_torch.plotting",
            "betacores_tpu_torch.utils.export", "betacores_tpu_torch.entry"] + [
        f"betacores_tpu_torch.examples.{n}" for n in
        ("zellner_logreg", "zellner_gaussian", "multiclass", "group_selection",
         "poisson_regression", "mvn_unknown_cov", "zellner_neural_linear", "shf_logreg",
         "run_sweep", "plot_results", "dp_bpsvi", "streaming_build", "streaming_outofcore",
         "preprocess", "data_tabulate", "virtual_mesh_headline", "bench_select_pass",
         "bench_group_pass", "bench_native_loader", "fulldata_roofline")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'betacores_tpu', "
            "'matplotlib')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert r.returncode == 0, r.stderr
