"""The mesh's collective counters on the program's recorder
(betacores_tpu_torch/parallel/mesh.py: ``mesh.collectives``,
``mesh.bytes``; utils/profiling.py) and the sharded builder's ``refine``
span, on a recorded sharded build over a gloo world of one: the counters
agree with the mesh's own ``calls``, the bytes are those of the tensors
handed to ``torch.distributed``, the step's collectives count under
``refine`` and the select's under no span, and ``refine`` is the parent of
the refits' ``newton`` spans. The same build captured on the card is in
test_torch_mesh_counters_cuda.py. This file imports no JAX."""

import pytest
import torch
import torch.distributed as dist

from betacores_tpu_torch.coresets import IncrementalConfig, init_state
from betacores_tpu_torch.inference import logreg_laplace_sampler
from betacores_tpu_torch.models import logreg
from betacores_tpu_torch.parallel import (make_mesh, make_sharded_incremental_builder,
                                          shard_data, world_of_one)
from betacores_tpu_torch.utils import profiling

N, D, M, ITRS = 600, 5, 12, 3
CFG = dict(projection_dim=16, n_subsample_select=64, n_subsample_opt=32, opt_itrs=6,
           i0=0.5, use_beta=True)


def by_name(counters: dict, name: str) -> dict:
    """{scope: count} of counter ``name``."""
    return {scope: n for (k, scope), n in counters.items() if k == name}


def recorded_build(device, graph: bool, backend: str):
    """A small sharded fused build on a world of one, recorded: (the
    recorder's snapshot, the mesh's ``calls``, the final weights)."""
    with world_of_one(backend):
        mesh = make_mesh(1, 1, device=device)
        gen = torch.Generator().manual_seed(0)
        X = torch.randn((N, D), generator=gen)
        y = torch.where(X @ torch.ones(D) + 0.3 * torch.randn(N, generator=gen) > 0, 1.0, -1.0)
        block, n_true = shard_data((y[:, None] * X).to(device), mesh)
        builder = make_sharded_incremental_builder(block, n_true, logreg.bundle(),
                                                   logreg_laplace_sampler(),
                                                   IncrementalConfig(**CFG), mesh, graph=graph)
        assert builder.route == "fused"
        st = init_state(M, D, beta=0.2, sampler_aux=torch.zeros(D, device=device),
                        device=device)
        profiling.reset()
        mesh.calls.clear()
        with profiling.recording():
            st = builder.build(st, ITRS, builder.generator_draws(5))
            snap = profiling.snapshot()
        profiling.reset()
        return snap, dict(mesh.calls), st.wts.cpu()


def check_counts(snap, calls) -> None:
    """What both the eager and the captured build must show."""
    T = CFG["opt_itrs"]
    collectives = by_name(snap.counters, "mesh.collectives")
    assert sum(collectives.values()) == sum(calls.values())
    # a step's two psums under refine; the select's three psums and its
    # all_gather under no span
    assert collectives == {"refine": 2 * T * ITRS, None: 4 * ITRS}
    spans = {(s.name, s.parent) for s in snap.spans}
    assert {("refine", None), ("newton", "refine")} <= spans
    assert snap.counters[("newton.iters_run", "refine")] == 8 * T * ITRS


@pytest.fixture
def sized(monkeypatch):
    """The bytes of every tensor handed to torch.distributed's all_reduce
    and all_gather (its own part), summed."""
    seen = [0]
    reduce, gather = dist.all_reduce, dist.all_gather

    def all_reduce(t, *a, **k):
        seen[0] += t.numel() * t.element_size()
        return reduce(t, *a, **k)

    def all_gather(parts, t, *a, **k):
        seen[0] += t.numel() * t.element_size()
        return gather(parts, t, *a, **k)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "all_gather", all_gather)
    return seen


def test_eager_counters_agree_with_the_mesh(sized):
    snap, calls, _ = recorded_build(torch.device("cpu"), False, "gloo")
    check_counts(snap, calls)
    assert sum(by_name(snap.counters, "mesh.bytes").values()) == sized[0] > 0


def test_counters_stay_off_without_the_recorder():
    with world_of_one("gloo"):
        mesh = make_mesh(1, 1)
        profiling.reset()
        mesh.psum(torch.ones(3), "data")
        assert not by_name(profiling.snapshot().counters, "mesh.collectives")
        assert mesh.calls["psum"] == 1
