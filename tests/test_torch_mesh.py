"""The port's mesh (betacores_tpu_torch/parallel/mesh.py): rank layout, the
axis groups and their collectives, row padding, ``shard_weights``, the
distributed argmax's tie-break to the lower shard, and ``make_mesh``'s
refusals. A world of 1 runs in this process; the (2, 2) world runs in
spawned gloo processes (tests/torch_dist_worker.py)."""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from betacores_tpu.parallel import auto_mesh_shape as jauto_mesh_shape
from betacores_tpu_torch.parallel import (DATA_AXIS, SAMP_AXIS, auto_mesh_shape,
                                          make_mesh, require_axes, shard_data,
                                          shard_weights)
from torch_dist_worker import run_world

torch.set_num_threads(1)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_auto_mesh_shape_matches_reference():
    for n in range(1, 17):
        assert auto_mesh_shape(n) == jauto_mesh_shape(n)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        make_mesh(1, 1)
    with pytest.raises(ValueError):
        require_axes(object())


def test_world_of_one(world_of_one):
    """A (1, 1) mesh: its collectives still go through torch.distributed
    and are counted; a mesh of another size raises; the gloo backend
    refuses a tensor it cannot serve."""
    with pytest.raises(ValueError):
        make_mesh(2, 1)
    with pytest.raises(ValueError):
        make_mesh(1, 2)
    mesh = make_mesh(1, 1)
    assert (mesh.ax_d, mesh.ax_s, mesh.rank) == (0, 0, 0)
    assert require_axes(mesh) == (1, 1) and mesh.device == torch.device("cpu")
    x = torch.arange(6.0).reshape(2, 3)
    s = mesh.psum(x, DATA_AXIS)
    assert torch.equal(s, x) and s.data_ptr() != x.data_ptr()
    g = mesh.all_gather(x, SAMP_AXIS)
    assert g.shape == (1, 2, 3) and torch.equal(g[0], x)
    assert mesh.calls == {"psum": 1, "all_gather": 1}
    with pytest.raises(ValueError):
        mesh.psum(torch.zeros(3, device="meta"), DATA_AXIS)
    data = torch.arange(10.0).reshape(5, 2)
    block, n = shard_data(data, mesh)
    assert n == 5 and torch.equal(block, data)


@pytest.fixture(scope="module")
def world_2x2():
    """Each rank's mesh report, and a tie: both data shards hold the same
    rows and draw the same local indices, so every candidate ties with its
    copy on the other shard."""
    rng = np.random.default_rng(5)
    n, D, S, T = 40, 3, 8, 4
    X = rng.normal(size=(n, D)).astype(np.float32)
    M = 4
    state = dict(wts=np.zeros(M, np.float32), idcs=-np.ones(M, np.int32),
                 pts=np.zeros((M, D), np.float32), m=np.int32(0), beta=np.float32(0.3),
                 sampler_aux=np.zeros(D, np.float32))
    sub = rng.integers(0, n, 10)
    opt_sub = rng.integers(0, n, (T, 5))
    tie = dict(data=np.concatenate([X, X]), weights=None, model="logreg",
               cfg=dict(projection_dim=S, n_subsample_select=20, n_subsample_opt=10,
                        opt_itrs=T, i0=0.5, use_beta=True),
               state=state, itrs=1,
               sel=[(rng.normal(size=(S, D)).astype(np.float32), [sub, sub])],
               opt=[(rng.normal(size=(T, S, D)).astype(np.float32), [opt_sub, opt_sub])])
    data = np.arange(14, dtype=np.float32).reshape(7, 2)
    report = dict(kind="mesh", data=data, weights=np.arange(1, 8, dtype=np.float32))
    return run_world(2, 2, {"report": report, "tie": tie}), n


def test_rank_layout_and_axis_groups(world_2x2):
    """Rank r sits at (r // n_samp, r % n_samp); a data line is the ranks of
    one ax_s, a samp line those of one ax_d, both in axis order."""
    ranks, _ = world_2x2
    for r, out in enumerate(ranks):
        rep = out["jobs"]["report"]
        ax_d, ax_s = divmod(r, 2)
        assert rep["ax"] == (ax_d, ax_s) and rep["rank"] == r
        assert rep["psum"] == {DATA_AXIS: [float(ax_s + 2 + ax_s)],
                               SAMP_AXIS: [float(4 * ax_d + 1)]}
        assert rep["gather"] == {DATA_AXIS: [float(ax_s), float(2 + ax_s)],
                                 SAMP_AXIS: [float(2 * ax_d), float(2 * ax_d + 1)]}
        assert rep["unchanged"] == [float(r)]
        assert rep["calls"] == {"psum": 2, "all_gather": 2}


def test_row_padding_and_weights(world_2x2):
    """N = 7 over 2 data shards: 4 rows each, the second padded with one
    zero row and a zero weight; both ranks of a samp line hold one block."""
    ranks, _ = world_2x2
    data = np.arange(14, dtype=np.float32).reshape(7, 2)
    u = np.arange(1, 8, dtype=np.float32)
    for r, out in enumerate(ranks):
        rep = out["jobs"]["report"]
        ax_d = r // 2
        assert rep["n_true"] == 7
        want = np.zeros((4, 2), np.float32)
        want[:4 - ax_d] = data[4 * ax_d:4 * ax_d + 4]
        np.testing.assert_array_equal(rep["block"], want)
        want_u = np.zeros(4, np.float32)
        want_u[:4 - ax_d] = u[4 * ax_d:4 * ax_d + 4]
        np.testing.assert_array_equal(rep["u_block"], want_u)


def test_argmax_tie_goes_to_the_lower_shard(world_2x2):
    ranks, n = world_2x2
    states = [out["jobs"]["tie"]["state"] for out in ranks]
    assert all(int(st["m"]) == 1 for st in states)
    f = {int(st["idcs"][0]) for st in states}
    assert len(f) == 1 and 0 <= f.pop() < n      # the winner is shard 0's row
