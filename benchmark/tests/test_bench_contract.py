"""BENCHMARK.json against the benchmark's contract, and the files the harness
finds by name."""

import json
import re
from importlib import import_module
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|projection|head)", re.I)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(isinstance(w, str) and _line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()
        assert not p.rstrip("/").endswith("_torch")
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p.rstrip("/") + "/") for p in paths), word
            assert (REPO / word).is_file()
    for p in paths:
        for f in (REPO / p).rglob("*"):
            if "__pycache__" not in f.parts:
                assert PATH.match(str(f.relative_to(REPO))), f


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = BENCH[section]
    assert 1 <= len(entries) <= {"configs": 24, "workloads": 24, "end_to_end": 16,
                                 "per_layer": 128}[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - KEYS[section]
        assert set(e) >= KEYS[section] and extra <= {"workloads"}, e
        if extra:
            assert section in ("end_to_end", "per_layer")
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["source"].startswith("https://")
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert key in cfg
        import_module(f"benchmark.families.{cfg['family']}")


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"])
        cell = harness.Cell(w["name"], bench=BENCH)
        assert set(cell.limits) <= set(harness.NUMBERS) and "select_gap" in cell.limits
        if w["chips"] > 1:     # one rank a card
            mesh = cell.config["mesh"]
            assert mesh["data"] * mesh["samp"] == w["chips"]


def _reported(metric: dict) -> set:
    return set(metric.get("workloads", [w["name"] for w in BENCH["workloads"]]))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert _reported(m) <= _reported(e2e[m["moves"]]) and _reported(m) <= cells
        assert callable(import_module(f"benchmark.metrics.{m['name']}").read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        names = {m["name"] for m in BENCH["end_to_end"] if cell in _reported(m)}
        assert "setup_s" in names and len(names) >= 2
        assert any(cell in _reported(m) for m in BENCH["per_layer"])


def test_traffic_files():
    for w in BENCH["workloads"]:
        t = harness.Cell(w["name"], bench=BENCH).traffic
        assert t["select"] in ("subsample", "all") and t["refine"] in ("subsample", "all")
        assert t["refit_every"] >= 1 and 1 <= t["compare_selections"]
