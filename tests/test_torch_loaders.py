"""The port's host loaders (betacores_tpu_torch/data/loaders.py) and native
parser (betacores_tpu_torch/data/native_loader.py) against the JAX
package's (betacores_tpu/data/loaders.py, native_loader.py): the same files
give equal arrays, lists and errors. The files are the repository's own
data (``data/movielens_grouped.npz`` and its group pickle) and temporary
files written here from a numpy seed.

The port builds its parser from ``native/loader.cpp`` with ``g++`` into
``build/native/``; its parse must equal the JAX module's bit for bit, and
without a compiler it falls back to the same numpy parse as the
reference's."""

import os
import pickle
from pathlib import Path

import numpy as np
import pytest

import betacores_tpu.data.loaders as jld
import betacores_tpu.data.native_loader as jnl
import betacores_tpu_torch.data as tdata
import betacores_tpu_torch.data.loaders as tld
import betacores_tpu_torch.data.native_loader as tnl

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "data" / "movielens_grouped.npz"
PICKLE = ROOT / "data" / "vq_groups_sensemake_movielens_grouped.pk"


def _equal(got, want):
    """Equal values, dtypes and shapes, through tuples and lists."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _npz(tmp_path, name, **arrays):
    path = str(tmp_path / name)
    np.savez(path, **arrays)
    return path


@pytest.mark.parametrize("case", ["repo", "test_arrays", "split_01_labels", "split_tiny_ttr"])
def test_load_npz_equals_jax(tmp_path, case):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(23, 4))
    y = np.where(rng.uniform(size=23) > 0.5, 1.0, -1.0)
    if case == "repo":
        path, ttr = str(NPZ), 0.2
    elif case == "test_arrays":
        path, ttr = _npz(tmp_path, "a.npz", X=X, y=y, Xt=X[:5], yt=y[:5]), 0.2
    elif case == "split_01_labels":
        path, ttr = _npz(tmp_path, "b.npz", X=X, y=(y > 0).astype(float)), 0.3
    else:           # int(ttr * N) = 0: one test row all the same
        path, ttr = _npz(tmp_path, "c.npz", X=X, y=y, Xt=np.zeros(1), yt=np.zeros(1)), 0.01
    _equal(tld.load_npz(path, ttr), jld.load_npz(path, ttr))


def test_load_npz_refuses_a_split_without_training_rows(tmp_path):
    path = _npz(tmp_path, "one.npz", X=np.ones((1, 3)), y=np.ones(1))
    for mod in (tld, jld):
        with pytest.raises(ValueError, match="at least one training row"):
            mod.load_npz(path)


def test_std_cov_and_add_intercept_equal_jax():
    """Whitening fit on the repo's train rows and applied to its test rows
    with the returned (mean, cov); the intercept column untouched."""
    X, Y, Xt, Yt = tld.load_npz(str(NPZ))
    got, want = tld.std_cov(X, Y), jld.std_cov(X, Y)
    _equal(got, want)
    np.testing.assert_array_equal(got[0][:, -1], X[:, -1])
    _equal(tld.std_cov(Xt, Yt, got[3], got[4]), jld.std_cov(Xt, Yt, want[3], want[4]))
    for dt in (np.float32, np.float64):
        A = np.random.default_rng(1).normal(size=(6, 3)).astype(dt)
        _equal(tld.add_intercept(A), jld.add_intercept(A))


def test_groups_pickle_equals_jax(tmp_path):
    _equal(tld.load_groups_pickle(str(PICKLE)), jld.load_groups_pickle(str(PICKLE)))
    path = tmp_path / "g.pk"
    with open(path, "wb") as f:
        pickle.dump(([np.arange(3), [np.int64(7), 9]], [(0.1, 0.9), (0.5, 0.5)]), f)
    got = tld.load_groups_pickle(str(path))
    _equal(got, jld.load_groups_pickle(str(path)))
    assert got[0] == [[0, 1, 2], [7, 9]] and all(type(i) is int for i in got[0][1])


def test_dataset_paths_equal_jax(tmp_path, monkeypatch):
    """$BETACORES_DATA first, then the repo's data/; a dataset path given to
    ``groups_pickle_path`` searches only its own directory."""
    env = tmp_path / "env"
    env.mkdir()
    np.savez(env / "mine.npz", X=np.zeros((2, 2)), y=np.zeros(2))
    (env / "vq_groups_sensemake_mine.pk").write_bytes(PICKLE.read_bytes())
    monkeypatch.setenv("BETACORES_DATA", str(env))
    for name in ("mine", "movielens_grouped", "no_such_dataset"):
        assert tld.reference_dataset_path(name) == jld.reference_dataset_path(name)
        assert tld.groups_pickle_path(name) == jld.groups_pickle_path(name)
    assert tld.reference_dataset_path("mine") == str(env / "mine.npz")
    assert tld.reference_dataset_path("movielens_grouped") == str(NPZ)
    assert tld.groups_pickle_path("movielens_grouped") == str(PICKLE)
    other = str(tmp_path / "elsewhere" / "movielens_grouped.npz")
    for name, where in (("movielens_grouped", str(NPZ)), ("movielens_grouped", other),
                        ("mine", str(NPZ))):
        assert tld.groups_pickle_path(name, where) == jld.groups_pickle_path(name, where)
    assert tld.groups_pickle_path("movielens_grouped", other) is None
    monkeypatch.delenv("BETACORES_DATA")
    assert tld._data_roots()[1] == str(ROOT / "data")


def test_uci_regression_equals_jax(tmp_path):
    """Every branch of ``load_uci_regression`` on small files of its
    formats: boston (csv and housing.data), news (its ``_is_`` columns
    dropped, the first row and two columns dropped, min-max scaled), year
    and prices2018."""
    rng = np.random.default_rng(3)
    A = np.round(rng.normal(size=(12, 5)) * 10, 3)
    dirs = {k: tmp_path / k for k in ("csv", "data", "news", "year", "prices")}
    for p in dirs.values():
        p.mkdir()
    np.savetxt(dirs["csv"] / "boston.csv", A, delimiter=",", header="a,b,c,d,MEDV",
               comments="")
    np.savetxt(dirs["data"] / "housing.data", A)
    header = "url,timedelta,n_tokens,data_is_tech,kw_max,weekday_is_monday,shares"
    news = np.round(rng.uniform(size=(9, 7)) * 100, 2)
    news[:, 4] = 3.0                      # a constant column: its span is taken as 1
    np.savetxt(dirs["news"] / "news.csv", news, delimiter=",", header=header, comments="")
    np.savetxt(dirs["year"] / "year.txt", A, delimiter=",")
    np.save(dirs["prices"] / "prices2018.npy", A)
    for name, where in (("boston", "csv"), ("boston", "data"), ("news", "news"),
                        ("year", "year"), ("prices2018", "prices")):
        got = tld.load_uci_regression(name, str(dirs[where]))
        _equal(got, jld.load_uci_regression(name, str(dirs[where])))
        assert got[1].shape == (got[0].shape[0], 1)
    assert tld.load_uci_regression("news", str(dirs["news"]))[0].shape == (8, 2)
    for mod in (tld, jld):
        with pytest.raises(ValueError, match="Unsupported"):
            mod.load_uci_regression("iris", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="year: none of"):
            mod.load_uci_regression("year", str(dirs["csv"]))


def test_chip_smoke_movielens_groups_uses_the_port_loaders():
    """``chip_smoke.movielens_groups`` reads the data through the port's
    ``load_npz``/``std_cov``/``load_groups_pickle``; its arrays equal the
    reference preparation (examples/group_selection.py:56-100) done with
    the JAX package's loaders, bit for bit."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    Z, Xt, Yt, groups = chip_smoke.movielens_groups(trial=1)
    X, Y, Xt0, Yt0 = jld.load_npz(str(NPZ))
    X, Y, _, mean, cov = jld.std_cov(X, Y)
    g0, demos = jld.load_groups_pickle(str(PICKLE))
    g0 = [[k for k in g if k < X.shape[0]] for g in g0]
    rng = np.random.default_rng(1)
    for g, dem in zip(g0, demos):
        o = int(len(g) * min(dem[0] * chip_smoke.GRP_F_RATE * 3, 0.9))
        if o > 0:
            rows = rng.choice(g, size=o, replace=False)
            for c in rng.choice(X.shape[1], max(X.shape[1] // 2, 1), replace=False):
                X[rows, c] = rng.normal(0, 10, size=o)
            Y[rows] = -Y[rows]
    rnd = np.random.default_rng(42).uniform()
    n_pos = (Yt0 == 1).sum()
    if not 0.45 * len(Yt0) <= n_pos <= 0.55 * len(Yt0):
        maj = 1.0 if n_pos > len(Yt0) - n_pos else -1.0
        keep_min = np.where(Yt0 == -maj)[0]
        keep_maj = np.where(Yt0 == maj)[0][:len(keep_min) + int(0.01 * len(keep_min) * rnd)]
        keep = np.concatenate([keep_maj, keep_min])
        Xt0, Yt0 = Xt0[keep], Yt0[keep]
    Xt0, Yt0, _, _, _ = jld.std_cov(Xt0, Yt0, mean, cov)
    _equal((Z, Xt, Yt), ((Y[:, None] * X).astype(np.float32), Xt0.astype(np.float32),
                         Yt0.astype(np.float32)))
    assert groups == g0


# --- the native parser -----------------------------------------------------------


def _csv(tmp_path, rows=400, cols=6, seed=0):
    data = np.random.default_rng(seed).normal(size=(rows, cols)) * 10.0 ** np.arange(-2, cols - 2)
    path = str(tmp_path / "x.csv")
    np.savetxt(path, data, delimiter=",", fmt="%.7g")
    with open(path, "a") as f:
        f.write("1e-3,-2.5E+2,-inf,nan,+7,0\n")
    return path


def _svm(tmp_path):
    path = str(tmp_path / "x.svm")
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for r in range(300):
            idx = np.sort(rng.choice(np.arange(1, 41), size=5, replace=False))
            feats = " ".join(f"{i}:{v:.6g}" for i, v in zip(idx, rng.normal(size=5)))
            f.write(f"{1 if r % 3 else -1} {'qid:4 ' if r % 7 == 0 else ''}{feats}\n")
    return path


@pytest.fixture
def native():
    """The port's parser, built with g++ into build/native/."""
    tnl._get_lib.cache_clear()
    if not tnl.native_available():
        pytest.skip("no C++ compiler on this host")
    lib = tnl._get_lib()
    yield lib
    tnl._get_lib.cache_clear()


def test_native_parse_equals_the_jax_module_bit_for_bit(tmp_path, native):
    assert jnl.native_available()
    path = Path(native._name)
    assert path.parent == ROOT / "build" / "native" and path.name.startswith("libbcloader-")
    csv, svm = _csv(tmp_path), _svm(tmp_path)
    for threads in (0, 1, 3):
        _equal(tnl.load_csv(csv, n_threads=threads), jnl.load_csv(csv, n_threads=threads))
        _equal(tnl.load_svmlight(svm, 50, threads), jnl.load_svmlight(svm, 50, threads))
    _equal(tnl.load_csv(csv, skip_header=2), jnl.load_csv(csv, skip_header=2))
    assert tnl.load_csv(csv).shape == (401, 6)


def _no_compiler(monkeypatch):
    monkeypatch.setattr(tnl, "_compiler", lambda: None)
    tnl._get_lib.cache_clear()


def test_fallback_without_a_compiler_parses_as_numpy(tmp_path, monkeypatch):
    """No compiler: the reference's numpy parse (genfromtxt, one row 2-D;
    svmlight by hand), equal to the native parse of the same files."""
    csv, svm = _csv(tmp_path), _svm(tmp_path)
    native_csv, native_svm = jnl.load_csv(csv), jnl.load_svmlight(svm, 50)
    _no_compiler(monkeypatch)
    try:
        assert not tnl.native_available()
        got = tnl.load_csv(csv)
        np.testing.assert_array_equal(got, native_csv)
        _equal(tnl.load_svmlight(svm, 50), jnl._svmlight_numpy(svm, 50))
        _equal(tnl.load_svmlight(svm, 50), native_svm)
        one = tmp_path / "one.csv"
        one.write_text("1.0,2.0,3.0\n")
        assert tnl.load_csv(str(one)).shape == (1, 3)
    finally:
        tnl._get_lib.cache_clear()


def test_svmlight_qid_and_bad_index(tmp_path, native):
    f = tmp_path / "q.svm"
    f.write_text("1 qid:3 1:2.5 4:1.0\n-1 2:0.5\n")
    X, y = tnl.load_svmlight(str(f), n_features=4)
    np.testing.assert_array_equal(X, [[2.5, 0, 0, 1.0], [0, 0.5, 0, 0]])
    np.testing.assert_array_equal(y, [1.0, -1.0])
    _equal(tnl._svmlight_numpy(str(f), 4), (X, y))
    f2 = tmp_path / "z.svm"
    f2.write_text("1 0:3.5 4:1.0\n")
    with pytest.raises(ValueError, match="1-based"):
        tnl._svmlight_numpy(str(f2), n_features=4)


def test_a_failed_build_raises(monkeypatch):
    """A compiler that fails is an error, never a quiet numpy fallback."""
    import shutil

    monkeypatch.setattr(tnl, "_compiler", lambda: shutil.which("false"))
    tnl._get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed on"):
            tnl.native_available()
    finally:
        tnl._get_lib.cache_clear()
    assert not list((ROOT / "build" / "native").glob("*.tmp"))


def test_data_package_exports_the_loaders():
    for name in ("load_npz", "std_cov", "add_intercept", "load_groups_pickle",
                 "reference_dataset_path", "groups_pickle_path", "load_uci_regression",
                 "native_loader"):
        assert getattr(tdata, name) is not None and name in tdata.__all__
    assert os.path.basename(tnl.SOURCE) == "loader.cpp"
