"""The rest of the port's drivers (betacores_tpu_torch/examples/) against the
JAX package's (examples/), on the CPU: DP-BPSVI, preprocessing and the
dataset table, and the four microbenchmarks; and every driver's flags
against its JAX script's. Each runs in-process at the arguments of its JAX
test in tests/test_examples.py, and so does the JAX script. Where the data
are the same the results must be: ``preprocess`` writes the same arrays bit
for bit from the same raw files (the tests write them, for all eight
subcommands), ``data_tabulate`` prints the same table, and ``dp_bpsvi``
reports the same privacy bound in every row (rtol 1e-9: it is host
arithmetic) and the same prior reverse KL (rtol 1e-5, float32)."""

import ast
import json
import os
import pickle

import numpy as np
import pytest

from test_torch_examples import ROOT, _assert_same_layout, _run_jax, _run_port

PORT_EXAMPLES = os.path.join(ROOT, "betacores_tpu_torch", "examples")

DP = ["--N", "400", "--d", "3", "--M", "6", "--proj-dim", "16", "--opt-itrs", "30",
      "--n-subsample-opt", "64", "--noise-grid", "1.0"]


def _json_last(out):
    return json.loads(out.strip().splitlines()[-1])


def _run_jax_exits(script, argv, monkeypatch):
    """A JAX script that ends in ``sys.exit(main())``: it must exit 0."""
    with pytest.raises(SystemExit) as e:
        _run_jax(script, argv, monkeypatch)
    assert e.value.code in (0, None)


def test_dp_bpsvi_matches_the_jax_driver(tmp_path, capsys, monkeypatch):
    d_port, d_jax = tmp_path / "port", tmp_path / "jax"
    _run_port("dp_bpsvi", DP + ["--results-dir", str(d_port)])
    port_out = capsys.readouterr().out
    _run_jax("dp_bpsvi.py", DP + ["--results-dir", str(d_jax)], monkeypatch)
    jax_out = capsys.readouterr().out
    got, want = _json_last(port_out), _json_last(jax_out)
    assert os.listdir(d_port) == os.listdir(d_jax) == ["results_dpbpsvi_N400_M6_poisson_1.pk"]
    with open(d_port / "results_dpbpsvi_N400_M6_poisson_1.pk", "rb") as f:
        pk = pickle.load(f)
    with open(d_jax / "results_dpbpsvi_N400_M6_poisson_1.pk", "rb") as f:
        pk_jax = pickle.load(f)
    assert set(pk) == set(pk_jax) and set(pk["config"]) - {"device", "seed"} == set(
        pk_jax["config"])
    _assert_same_layout({k: v for k, v in pk.items() if k != "config"},
                        {k: v for k, v in pk_jax.items() if k != "config"})
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    np.testing.assert_allclose([r["eps"] for r in got["rows"]],
                               [r["eps"] for r in want["rows"]], rtol=1e-9)
    assert [r["noise"] for r in got["rows"]] == [r["noise"] for r in want["rows"]]
    np.testing.assert_allclose(got["rkl_prior"], want["rkl_prior"], rtol=1e-5)
    # the JAX test's bound
    np_row, dp_row = got["rows"]
    assert np_row["eps"] == float("inf") and dp_row["eps"] > 0
    assert dp_row["rkl"] < got["rkl_prior"] / 10
    for line in ("N=400 d=3 M=6 delta=1e-05", "noise        eps          rKL  nnz   t[s]"):
        assert line in port_out and line in jax_out


# ---- preprocess: raw files for every subcommand ----

ADULT_RACES = ["White", "Black", "Asian-Pac-Islander", "Other"]


def _write_adult(path, rng, n=300):
    rows = ["|1x3 Cross validator"]
    for i in range(n):
        work = "?" if i % 37 == 5 else rng.choice(["Private", "State-gov", "Self-emp"])
        rows.append(", ".join(str(v) for v in [
            int(rng.integers(17, 90)), work, int(rng.integers(10_000, 500_000)),
            rng.choice(["Bachelors", "HS-grad"]), int(rng.integers(1, 16)),
            rng.choice(["Married", "Never-married"]), rng.choice(["Sales", "Tech", "Craft"]),
            "Not-in-family", rng.choice(ADULT_RACES), rng.choice(["Male", "Female"]),
            int(rng.integers(0, 5000)), int(rng.integers(0, 300)), int(rng.integers(10, 60)),
            "United-States", rng.choice(["<=50K", ">50K"])]))
    path.write_text("\n".join(rows) + "\n")


def _write_diabetes(path, rng, n=600):
    cols = ["race", "gender", "age", "readmitted", "time_in_hospital", "num_lab_procedures",
            "num_procedures", "num_medications", "number_outpatient", "number_emergency",
            "number_inpatient", "number_diagnoses"]
    rows = [",".join(cols)]
    for i in range(n):
        race = "?" if i % 41 == 3 else rng.choice(["Caucasian", "AfricanAmerican"])
        rows.append(",".join([race, rng.choice(["Male", "Female"]),
                              rng.choice(["[50-60)", "[60-70)", "[70-80)"]),
                              rng.choice(["NO", "<30", ">30"])]
                             + [str(int(v)) for v in rng.integers(0, 20, size=8)]))
    path.write_text("\n".join(rows) + "\n")


def _write_phishing(path, rng, n=200):
    rows = [",".join([f"f{j}" for j in range(8)] + ["label"])]
    for _ in range(n):
        rows.append(",".join(str(int(v)) for v in list(rng.integers(-1, 2, size=8))
                             + [rng.choice([-1, 1])]))
    path.write_text("\n".join(rows) + "\n")


def _write_webspam(path, rng, n=150):
    rows = []
    for _ in range(n):
        idx = np.sort(rng.choice(20, 6, replace=False)) + 1
        rows.append(f"{rng.choice([-1, 1])} " + " ".join(
            f"{i}:{v:.6f}" for i, v in zip(idx, rng.normal(size=6))))
    path.write_text("\n".join(rows) + "\n")


def _raw_files(d):
    """{subcommand: preprocess arguments} over raw files written in ``d``
    (covtype, mnist2, housing and movielens as tests/test_examples.py writes
    them)."""
    rng = np.random.default_rng(0)
    for name, write in (("adult.data", _write_adult), ("diabetic_data.csv", _write_diabetes),
                        ("phishing.csv", _write_phishing), ("webspam.svm", _write_webspam)):
        write(d / name, rng)
    np.savetxt(d / "cov.csv", np.c_[rng.normal(size=(50, 5)), rng.integers(1, 4, size=50)],
               delimiter=",")
    np.savez(d / "mnist.npz", X=rng.integers(0, 255, size=(40, 16)),
             y=rng.integers(0, 10, size=40))
    (d / "GB_FULL.txt").write_text("header\n" + "\n".join(
        "\t".join(["GB", code, "x", "x", "x", "x", "x", "x", "x", str(lat), str(lon), "1"])
        for code, lat, lon in [("AB1 0AA", 57.1, -2.2), ("ZZ9 9ZZ", 50.0, 0.1)]) + "\n")
    (d / "pp-2018.csv").write_text('"id","100000","2018","AB1 0AA","x"\n'
                                   '"id","250000","2018","ZZ9 9ZZ","x"\n'
                                   '"id","50000","2018","NO1 1NO","x"\n')
    rows = ["userId,movieId,rating,timestamp"] + [
        f"{rng.integers(1, 12)},{rng.integers(1, 30)},"
        f"{rng.choice([1.0, 2.0, 3.0, 4.0, 5.0])},{rng.integers(9e8, 1e9)}" for _ in range(400)]
    (d / "ml.csv").write_text("\n".join(rows))
    return {
        "adult": ["--raw", str(d / "adult.data"), "--cap", "20"],
        "diabetes": ["--raw", str(d / "diabetic_data.csv"), "--cap", "20"],
        "phishing": ["--raw", str(d / "phishing.csv")],
        "webspam": ["--raw", str(d / "webspam.svm"), "--subsample", "100", "--pca", "5"],
        "covtype": ["--raw", str(d / "cov.csv"), "--pca", "3"],
        "mnist2": ["--raw", str(d / "mnist.npz")],
        "housing": ["--raw", str(d / "pp-2018.csv"), str(d / "GB_FULL.txt")],
        "movielens": ["--raw", str(d / "ml.csv"), "--n-groups", "5", "--cap", "20"],
    }


@pytest.fixture(scope="module")
def preprocessed(tmp_path_factory):
    """Every subcommand run by the port and by the JAX script on the same
    raw files: (raw args, port output dir, JAX output dir, printed lines)."""
    import runpy
    import sys

    base = tmp_path_factory.mktemp("pre")
    raw = base / "raw"
    raw.mkdir()
    cmds = _raw_files(raw)
    printed = {}
    mp = pytest.MonkeyPatch()
    try:
        import contextlib
        import io

        for cmd, argv in cmds.items():
            outs = []
            for side in ("port", "jax"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    if side == "port":
                        _run_port("preprocess", [cmd] + argv + ["--out-dir", str(base / side)])
                    else:
                        mp.setattr(sys, "argv", ["preprocess.py", cmd] + argv
                                   + ["--out-dir", str(base / side)])
                        runpy.run_path(os.path.join(ROOT, "examples", "preprocess.py"),
                                       run_name="__main__")
                outs.append(buf.getvalue())
            printed[cmd] = outs
    finally:
        mp.undo()
    return cmds, base / "port", base / "jax", printed


def test_preprocess_writes_the_jax_scripts_files_bit_for_bit(preprocessed):
    cmds, d_port, d_jax, printed = preprocessed
    files = sorted(os.listdir(d_jax))
    assert sorted(os.listdir(d_port)) == files
    assert {"adult.npz", "diabetes.npz", "phishing.npz", "webspam.npz", "covtype.npz",
            "mnist2.npz", "prices2018.npy", "movielens.npz", "movielens5.npz",
            "movielens_grouped.npz"} <= set(files)
    for f in files:
        if f.endswith(".npz"):
            got, want = np.load(d_port / f), np.load(d_jax / f)
            assert sorted(got.files) == sorted(want.files), f
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (f, k)
                assert np.array_equal(got[k], want[k], equal_nan=True), (f, k)
        elif f.endswith(".npy"):
            got, want = np.load(d_port / f), np.load(d_jax / f)
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        else:
            with open(d_port / f, "rb") as a, open(d_jax / f, "rb") as b:
                assert pickle.load(a) == pickle.load(b), f
    # every subcommand wrote something and printed the JAX script's lines
    assert np.load(d_port / "adult.npz")["X"].shape[0] > 0
    for cmd, (port_out, jax_out) in printed.items():
        assert port_out == jax_out, cmd


@pytest.mark.parametrize("latex", [False, True])
def test_data_tabulate_prints_the_jax_scripts_table(preprocessed, capsys, monkeypatch, latex):
    _, d_port, _, _ = preprocessed
    argv = ["--dirs", str(d_port)] + (["--latex"] if latex else [])
    rows = _run_port("data_tabulate", argv)
    port_out = capsys.readouterr().out
    _run_jax("data_tabulate.py", argv, monkeypatch)
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert {r[0] for r in rows} >= {"ADULT", "MOVIELENS5", "WEBSPAM"}


# ---- the microbenchmarks, one tiny shape each ----

def test_bench_select_pass_prints_every_variant(capsys, monkeypatch):
    from betacores_tpu_torch.examples import bench_select_pass

    monkeypatch.setattr(bench_select_pass, "N", 3000)
    variants = ["matmul", "proj", "colsum", "select", "stream", "selloop", "colsum_mb",
                "select_mb", "colsum_ll", "colsum_b3", "select_b3", "colsum_bc",
                "colsum_bct", "select_bc", "dotsq", "dotsq_bf16"]
    out = bench_select_pass.main(["--reps", "2", "--variants"] + variants + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert list(out) == variants and all(np.isfinite(v) and v > 0 for v in out.values())
    for v in variants:
        assert f"{v:8s} " in printed and "ms/pass" in printed
    assert "on the CPU" in printed
    with pytest.raises(ValueError, match="retired"):
        bench_select_pass.main(["--variants", "kselect", "--device", "cpu"])


def test_bench_group_pass_per_pass_and_end_to_end(capsys):
    from betacores_tpu_torch.examples import bench_group_pass

    out = bench_group_pass.main(["--reps", "2", "--shapes", "2000x20", "--device", "cpu"])
    assert set(out["2000x20"]) == {"proj", "segsum", "onehot", "opt_old", "opt_new"}
    out = bench_group_pass.main(["--shapes", "400x20", "--end-to-end", "--M-groups", "2",
                                 "--opt-itrs", "5", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "N=2000 G=20 S=100" in printed and "onehot" in printed
    assert "end-to-end:" in printed and "2 groups selected" in printed
    assert np.isfinite(out["400x20"]["s"])


def test_bench_native_loader_matches_the_jax_script(tmp_path, capsys, monkeypatch):
    """The same files, byte for byte, and the JAX JSON record's keys, plus
    the port's upload onto --device. --seed 1 writes other files."""
    argv = ["--rows", "300", "--cols", "12", "--nnz", "4", "--scale-rows", "500"]
    rec = _run_port("bench_native_loader", argv + ["--workdir", str(tmp_path / "port")])
    port_out = capsys.readouterr()
    _run_jax_exits("bench_native_loader.py", argv + ["--workdir", str(tmp_path / "jax")],
                   monkeypatch)
    want = _json_last(capsys.readouterr().out)
    assert _json_last(port_out.out) == rec
    assert set(rec) == set(want) | {"upload"} and all(set(rec[k]) == set(want[k])
                                                      for k in ("csv", "svmlight", "csv_scale"))
    assert rec["csv"]["max_rel_err_vs_numpy"] < 1e-6 and rec["svmlight"]["max_rel_err"] < 1e-6
    assert rec["upload"]["device"] == "the CPU" and rec["upload"]["mb"] == 0.0
    assert "upload 0 MB of float32 rows onto cpu (the CPU)" in port_out.err
    files = ("webspam_shape.csv", "webspam_shape.svm", "scale.csv")
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    _run_port("bench_native_loader", argv + ["--workdir", str(tmp_path / "port"), "--seed", "1"])
    for f in files:
        stem, ext = os.path.splitext(f)
        assert ((tmp_path / "port" / f"{stem}_s1{ext}").read_bytes()
                != (tmp_path / "port" / f).read_bytes()), f


def test_fulldata_roofline_prints_its_roofline_and_quality(capsys, monkeypatch):
    from betacores_tpu_torch.examples import fulldata_roofline

    monkeypatch.setattr(fulldata_roofline, "M", 2)
    out = fulldata_roofline.main(["--n", "1500", "--configs", "fullopt", "--fullopt-itrs", "3",
                                  "--repeats", "1", "--quality", "--device", "cpu"])
    err = capsys.readouterr().err
    assert set(out) == {"fullopt"} and out["fullopt"]["opt_itrs"] == 3
    for name in out:
        assert out[name]["m"] == 2 and np.isfinite(out[name]["acc"])
        assert f"[{name}] wall" in err and f"[{name}] quality" in err
    assert "of float32 peak" in err and "on the CPU" in err


# ---- the flags: the JAX script's, plus --device and --seed ----

RESTS = ["dp_bpsvi", "streaming_build", "streaming_outofcore", "preprocess", "data_tabulate",
         "virtual_mesh_headline", "bench_select_pass", "bench_group_pass",
         "bench_native_loader", "fulldata_roofline"]
# defaults that name a place on the machine in the JAX script: the port's
# names its own data roots and the temporary directory instead
MACHINE_DEFAULTS = {("data_tabulate", "--dirs"), ("bench_native_loader", "--workdir")}
KEYS = ("default", "type", "action", "choices", "nargs")


def _flags(path):
    """{option: {keyword: source}} of every ``add_argument`` in a file."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            out[node.args[0].value] = {kw.arg: ast.unparse(kw.value) for kw in node.keywords
                                       if kw.arg in KEYS}
    return out


@pytest.mark.parametrize("name", RESTS)
def test_flags_are_the_jax_scripts_plus_the_ports(name):
    jax = _flags(os.path.join(ROOT, "examples", f"{name}.py"))
    port = _flags(os.path.join(PORT_EXAMPLES, f"{name}.py"))
    if "add_port_flags(ap" in open(os.path.join(PORT_EXAMPLES, f"{name}.py")).read():
        for flag, kws in _flags(os.path.join(PORT_EXAMPLES, "_common.py")).items():
            port.setdefault(flag, kws)
    assert set(port) - set(jax) <= {"--device", "--seed"}
    assert set(jax) <= set(port) and "--device" in port
    for flag, kws in jax.items():
        if (name, flag) not in MACHINE_DEFAULTS:
            assert port[flag] == kws, (name, flag)
