"""A cell over several cards, run on the CPU: a gloo world of four ranks
spawned as run.py spawns them (ranks.py), the tests' own cell at a tiny
size of the sharded configuration (world_run.py). The whole run, window
and check, is correct; each fault a
sharded cell can have makes it not correct; every rank runs rank 0's number
of selections; a rank that raises ends the run with a non-zero code, in
time. The one-card cells keep their classes, routes and draws, and the
reference's select over every row in blocks equals its select held whole."""

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness, reference
from benchmark.families import logreg
from benchmark.tests.tiny import CELLS, tiny_cell
from benchmark.tests.world_run import cell_args

REPO = Path(__file__).resolve().parents[2]
HELPER = Path(__file__).resolve().parent / "world_run.py"


def _world(*runs, timeout=400):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(HELPER), *runs], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return out.returncode, lines, out.stderr, time.perf_counter() - t0


@pytest.fixture(scope="module")
def results():
    impls = ["port", *sorted(faults.MESH_FAULTS)]
    rc, lines, err, _ = _world(*(f"11:{impl}" for impl in impls))
    assert rc == 0, err[-4000:]
    assert [line["impl"] for line in lines] == impls
    return {line["impl"]: line["result"] for line in lines}


def test_a_world_of_four_is_correct(results):
    res = results["port"]
    assert res["correct"], res["readings"]
    assert res["device"]["count"] == 4 and res["device"]["platform"] == "cpu"
    # every rank ran the selections rank 0's clock decided on
    assert res["ranks"]["selections"] == [res["attempted"]] * 4
    assert res["ranks"]["forbidden"] == [[]] * 4
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.MESH_FAULTS))
def test_a_broken_world_is_not_correct(results, fault):
    res = results[fault]
    assert not res["correct"], res["readings"]
    assert res["ranks"]["selections"] == [res["attempted"]] * 4
    if fault in ("altered", "duplicate"):
        got = res["checks"]["select_gap"]
        assert got["value"] > got["limit"], res["readings"]


def test_a_rank_that_raises_ends_the_run():
    rc, lines, err, took = _world("11:raises", timeout=300)
    assert rc != 0 and lines == [], err[-4000:]
    assert "rank 2 fails as the test asks" in err
    assert took < 240


def test_the_refinement_rows_split_by_shard():
    cell = harness.Cell(**cell_args())
    inputs = harness.make_inputs(cell, 5, torch.device("cpu"))
    N, D = inputs.data.shape[0], harness.data_shards(cell)
    rows = inputs.opt_idx.reshape(*inputs.opt_idx.shape[:-1], D, -1)
    for r in range(D):
        assert bool(((rows[..., r, :] >= r * N // D) & (rows[..., r, :] < (r + 1) * N // D)).all())
    assert harness.system(cell).__name__ == "ShardedPortImpl"


# each one-card cell's route at its own size, and a digest of its inputs at
# tiny.py's size on seed 2147483659, as the harness made them before it ran
# cells over several cards
ONE_CARD = {
    "logreg.subsampled_select": (
        {"buffer_slots": 128, "group_rows": 1, "groups": False, "n_groups": None,
         "n_opt": 200, "n_select": 1000, "opt_itrs": 500, "refit_every": 1,
         "selections": 100}, "b72c7050cd4eb5443647f85f"),
    "multiclass.groups_exact": (
        {"buffer_slots": 32768, "group_rows": 8192, "groups": True, "n_groups": 128,
         "n_opt": None, "n_select": None, "opt_itrs": 200, "refit_every": 1,
         "selections": 4}, "9fb0735ebf7840df032dd297"),
    "multiclass.full_select": (
        {"buffer_slots": 60, "group_rows": 1, "groups": False, "n_groups": None,
         "n_opt": 200, "n_select": None, "opt_itrs": 200, "refit_every": 1,
         "selections": 60}, "f6b7d74cdf1519660bf2653c"),
    "logreg.groups_exact": (
        {"buffer_slots": 210000, "group_rows": 10000, "groups": True, "n_groups": 100,
         "n_opt": None, "n_select": None, "opt_itrs": 100, "refit_every": 1,
         "selections": 20}, "2bacac5071faad828f2aa778"),
}


@pytest.mark.parametrize("name", CELLS)
def test_one_card_cells_are_unchanged(name):
    route, digest = ONE_CARD[name]
    cell = harness.Cell(name)
    assert cell.chips == 1 and cell.world is None and harness.system(cell) is harness.PortImpl
    assert cell.route == route
    h = hashlib.sha256()
    for t in harness.make_inputs(tiny_cell(name), 2147483659, torch.device("cpu")):
        if t is not None:
            h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest()[:24] == digest


def test_the_select_over_every_row_in_blocks_equals_it_whole(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    cfg = {"n_rows": 3000, "d": 10, "f_rate": 0.1, "projection_dim": 16, "n_newton": 8,
           "dtype": "float32", "i0": 1.0}
    data = logreg.make_data(gen, cfg).double()
    st = reference.RefState(torch.zeros(8, dtype=torch.float64),
                            torch.full((8,), -1), torch.zeros(8, 10, dtype=torch.float64),
                            0, 0.1, torch.zeros(10, dtype=torch.float64))
    z = torch.randn((16, 10), generator=gen, dtype=torch.float64)
    outs = []
    for whole in (reference.WHOLE_BYTES, 0):
        monkeypatch.setattr(reference, "WHOLE_BYTES", whole)
        ref = reference.Reference(logreg.reference_model(cfg), data, cfg, block=700)
        first = ref.select(st, z, None)
        second = ref.select(first.state._replace(wts=first.state.wts + 0.5 * (
            first.state.idcs >= 0)), z, None)
        outs.append((first, second))
    for a, b in zip(*outs):
        assert (a.best, a.add) == (b.best, b.add)
        assert torch.allclose(a.scores, b.scores, rtol=1e-12, atol=1e-15)
