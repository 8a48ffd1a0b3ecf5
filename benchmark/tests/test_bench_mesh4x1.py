"""The four-card cell ``logreg.mesh4x1`` as BENCHMARK.json declares it, and
its new per-layer metric ``collective_mib`` (metrics/collective_mib.py)
read from a recorded sharded build on a gloo world of one on the CPU."""

import types

import pytest
import torch
import torch.distributed as dist

from benchmark import harness, ranks
from benchmark.metrics import collective_mib

CELL = "logreg.mesh4x1"


def test_the_cell_resolves_to_four_cards_and_the_sharded_route():
    cell = harness.Cell(CELL)
    assert cell.chips == 4 and harness.data_shards(cell) == 4
    assert ranks.mesh_shape(cell) == (4, 1)
    assert harness.system(cell) is ranks.ShardedPortImpl
    r = cell.route
    assert r["n_select"] is None and r["n_opt"] == 200 and not r["groups"]
    assert (r["selections"], r["buffer_slots"], r["opt_itrs"]) == (100, 128, 500)
    assert cell.config["n_rows"] == 2 ** 26
    assert {m["name"] for m in cell.end_to_end} == {"selection_ms", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "select_ms", "refine_ms", "selection_mfu", "k3_roofline", "collective_ms",
        "collective_mib"}


def test_the_cell_compares_the_pick_and_the_later_weights():
    limits = harness.Cell(CELL).limits
    assert set(limits) == {"select_gap", "later_gap"}
    assert limits["select_gap"]["limit"] == 0.05
    later = limits["later_gap"]
    assert later["lower"] < later["limit"] < later["upper"]


def _build(itrs: int = 2):
    """A small sharded full-select fused build on a gloo world of one,
    recorded; returns the bytes handed to torch.distributed."""
    from betacores_tpu_torch.coresets import IncrementalConfig, init_state
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.models import logreg
    from betacores_tpu_torch.parallel import (make_mesh, make_sharded_incremental_builder,
                                              shard_data, world_of_one)
    from betacores_tpu_torch.utils import profiling

    seen = [0]
    reduce, gather = dist.all_reduce, dist.all_gather

    def all_reduce(t, *a, **k):
        seen[0] += t.numel() * t.element_size()
        return reduce(t, *a, **k)

    def all_gather(parts, t, *a, **k):
        seen[0] += t.numel() * t.element_size()
        return gather(parts, t, *a, **k)

    gen = torch.Generator().manual_seed(1)
    data = torch.randn((512, 4), generator=gen) + 0.5
    cfg = IncrementalConfig(projection_dim=16, n_subsample_select=None, n_subsample_opt=32,
                            opt_itrs=5, use_beta=True)
    with world_of_one("gloo"):
        mesh = make_mesh(1, 1)
        block, n_true = shard_data(data, mesh)
        builder = make_sharded_incremental_builder(block, n_true, logreg.bundle(),
                                                   logreg_laplace_sampler(), cfg, mesh)
        st = init_state(8, 4, beta=0.2, sampler_aux=torch.zeros(4), device="cpu")
        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        try:
            with profiling.recording():
                builder.build(st, itrs, builder.generator_draws(2))
        finally:
            dist.all_reduce, dist.all_gather = reduce, gather
    return seen[0]


def test_collective_mib_reads_the_bytes_of_a_recorded_build():
    from betacores_tpu_torch.utils import profiling

    profiling.reset()
    run = types.SimpleNamespace(profiled=[(0, 1), (1, 2)])
    assert collective_mib.read(run) is None             # nothing recorded yet
    nbytes = _build()
    assert nbytes > 0
    assert collective_mib.read(run) == pytest.approx(nbytes / 2 ** 20 / 2)
    profiling.reset()
