"""The sharded fused refinement (betacores_tpu_torch/parallel/sharded.py,
route "fused", K3's plain version on the CPU) keeps float32's precision
when the target's scale N / n is large: about 2^18 rows and 20 rows a
step, N / n = 13107, on gloo worlds of (1, 1), (2, 2) and (4, 1) ranks.

Each selection's refinement is worked out again by the benchmark's plain
float64 reference (benchmark/reference.py) from the state the program's
select left and with the same draws, and the program's weights are held
to it by the benchmark's own measure (benchmark/compare.py::weight_gaps:
the median over the live slots of each slot's gap, against the larger of
the reference's weight and the median live weight)."""

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.families import logreg as fam
from benchmark.reference import RefState, Reference
from betacores_tpu_torch.coresets import init_state, state_to_numpy

torch.set_num_threads(1)

N, D, S, T, M, ITRS = 1 << 18, 10, 50, 50, 16, 10
N_SEL, N_OPT, BETA = 200, 20, 0.1
CONFIG = {"n_rows": N, "d": D, "f_rate": 0.1, "projection_dim": S, "n_newton": 8,
          "dtype": "float32", "i0": 1.0}
# the selections compared: the later ones, whose buffers are fuller
LATER = 5
# the widest median gap allowed over the later selections. Measured (seed
# 2147484101, worlds (1, 1) / (2, 2) / (4, 1)): the program at most 1.7e-6
# / 9.7e-7 / 1.6e-6, as the single-device K1 route's 3-4e-6 (PERF.md); the
# same program summing each row's raw likelihoods (K3 without the shift by
# the row's value at the mode) up to 1.0e-4 / 5.2e-5 / 2.0e-5, growing with
# the selections. 1e-5 lies 6 times above the first and at least twice
# below the second.
TOL = 1e-5


def _job(n_data: int, seed: int = 2147484101):
    """The build's data, draws (each data shard's own subsample indices)
    and the float64 reference's draws (the same rows as global indices)."""
    gen = torch.Generator().manual_seed(seed)
    data = fam.make_data(gen, CONFIG)
    rows_loc = N // n_data
    sel, opt, ref_opt = [], [], []
    for _ in range(ITRS):
        z = torch.randn((S, D), generator=gen)
        idx = torch.randint(0, rows_loc, (n_data, N_SEL // n_data), generator=gen)
        sel.append((z.numpy(), list(idx.numpy())))
        z_all = torch.randn((T, S, D), generator=gen)
        local = torch.randint(0, rows_loc, (n_data, T, N_OPT // n_data), generator=gen)
        opt.append((z_all.numpy(), list(local.numpy())))
        first = rows_loc * torch.arange(n_data)[:, None, None]
        ref_opt.append((z_all, torch.cat(list(local + first), dim=1)))
    st0 = init_state(M, D, beta=BETA, sampler_aux=torch.zeros(D), device="cpu")
    job = dict(data=data.numpy(), model="logreg", state=state_to_numpy(st0), itrs=ITRS,
               sel=sel, opt=opt, stages=True,
               cfg=dict(projection_dim=S, n_subsample_select=N_SEL, n_subsample_opt=N_OPT,
                        opt_itrs=T, i0=1.0, use_beta=True))
    return data, job, ref_opt


def _ref_state(st: dict) -> RefState:
    t = torch.from_numpy
    return RefState(wts=t(st["wts"]), idcs=t(st["idcs"]).to(torch.int64), pts=t(st["pts"]),
                    m=int(st["m"]), beta=float(st["beta"]), aux=t(st["sampler_aux"]))


def _rank_builds(jobs):
    """One rank's builds: each (mesh shape, job) of ``jobs`` on a mesh of
    that shape made over the world, one after the other (every rank makes
    the meshes in the same order)."""
    from betacores_tpu_torch.parallel import make_mesh
    from torch_dist_worker import run_job

    torch.set_num_threads(1)
    return {shape: run_job(job, make_mesh(*shape)) for shape, job in jobs}


SHAPES = [(1, 1), (2, 2), (4, 1)]


@pytest.fixture(scope="module")
def builds():
    """Per mesh shape: (data, the reference's draws, each rank's report).
    The (1, 1) mesh runs in this process, the two four-rank meshes in one
    world of four spawned ranks."""
    from betacores_tpu_torch.parallel import run_world

    made = {shape: _job(shape[0]) for shape in SHAPES}
    jobs = lambda shapes: [(shape, made[shape][1]) for shape in shapes]
    ranks = (run_world(_rank_builds, 1, "gloo", (jobs(SHAPES[:1]),), timeout=300)
             + run_world(_rank_builds, 4, "gloo", (jobs(SHAPES[1:]),), timeout=300))
    return {shape: (made[shape][0], made[shape][2],
                    [r[shape] for r in ranks if shape in r]) for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_route_keeps_float32_precision_at_large_scale(builds, shape):
    data, ref_opt, got = builds[shape]
    assert len(got) == shape[0] * shape[1]
    assert all(g["route"] == "fused" for g in got)
    for g in got[1:]:                       # the state is replicated
        np.testing.assert_array_equal(g["state"]["wts"], got[0]["state"]["wts"])
    ref = Reference(fam.reference_model(CONFIG), data, CONFIG, torch.float64)
    gaps = []
    for it, (st_sel, st_opt) in enumerate(got[0]["stages"]):
        sel, after = _ref_state(st_sel), _ref_state(st_opt)
        w_ref = ref.refine(sel, *ref_opt[it]).wts
        gaps.append(compare.weight_gaps(sel, after, w_ref)[1])
    assert got[0]["stages"][-1][1]["m"] >= LATER + 1
    assert max(gaps[LATER:]) <= TOL, gaps
