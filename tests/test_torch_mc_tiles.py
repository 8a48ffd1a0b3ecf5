"""How K2 (csrc/multiclass_projection.cu) covers its shapes, checked on the
CPU through the host mirrors of its plan (ops/kernels.py::mc_plan, the
kernel's make_plan) and of its walk over the row tiles (mc_work)."""

import pytest

from betacores_tpu_torch.ops import kernels

H100_SMEM = 232_448        # shared memory a block may opt into on an H100
MAIN = dict(d=10, K=5, S=100)


def test_the_main_shape_keeps_theta_in_registers_with_every_lane_live():
    p = kernels.mc_plan(**MAIN, smem_limit=H100_SMEM)
    assert p.D == 10 and p.live == kernels.MC_THREADS == 800   # 8 rows x 100 samples
    assert p.rows == 128 and p.rows % (p.live // 100) == 0
    assert p.smem <= H100_SMEM


@pytest.mark.parametrize("S", [1, 31, 32, 33, 100, 111, 128, 257, 800])
def test_live_lanes_with_theta_in_registers(S):
    """One sample a thread in groups of S: at least 96 % of the block's
    lanes live at every S up to the block (775 of 800 at S = 31, 768 at
    S = 128, 771 at S = 257)."""
    p = kernels.mc_plan(4, 5, S, H100_SMEM)
    assert p.D == 4 and p.live % S == 0
    assert p.live / kernels.MC_THREADS >= 0.96


@pytest.mark.parametrize("shape,D", [((1, 13, 5), 2), ((1, 16, 5), 0), ((4, 9, 5), 4),
                                     ((4, 10, 5), 0), ((10, 5, 100), 10), ((10, 2, 100), 10),
                                     ((11, 2, 50), 0), ((6, 7, 50), 6), ((6, 8, 50), 0),
                                     ((32, 16, 111), 0), ((2, 2, 801), 0)])
def test_the_theta_path(shape, D):
    """Registers while theta, the logits and two temporaries a class,
    K (D + 3) with d padded to an even D, fit the budget of 65, D <= 10 and
    S <= the block; shared memory, with all 800 lanes live, otherwise."""
    d, K, S = shape
    p = kernels.mc_plan(d, K, S, H100_SMEM)
    assert p.D == D
    if D:
        assert K * (D + 3) <= kernels.MC_REG_BUDGET and D in (d, d + 1)
    else:
        assert p.live == kernels.MC_THREADS


@pytest.mark.parametrize("d", [1, 2, 10, 17, 32])
@pytest.mark.parametrize("K", [2, 5, 16])
def test_every_shape_the_first_kernel_took_still_fits(d, K):
    """The kernel's first design took any S with (d K + 8) S floats within
    the card's shared memory; the plan of each such largest S fits too."""
    S = H100_SMEM // 4 // (d * K + 8)
    for s in (S, max(1, S // 2), 1):
        p = kernels.mc_plan(d, K, s, H100_SMEM)
        assert p.rows >= 1 and p.smem <= H100_SMEM, (d, K, s, p)


def test_the_largest_s_at_d32_k16():
    p = kernels.mc_plan(32, 16, 111, H100_SMEM)
    assert p.D == 0 and p.smem <= H100_SMEM and p.rows >= 1


# (N, d, K, S, grid): ragged row counts, one tile +- 1, S dividing and not
# dividing the block, S above the block, more blocks than tiles
WALKS = {"main_ragged": (300, 10, 5, 100, 2), "tile_minus_1": (127, 10, 5, 100, 1),
         "tile_plus_1": (129, 10, 5, 100, 3), "S1": (5000, 3, 2, 1, 2),
         "S33": (101, 4, 2, 33, 2), "S257": (20, 4, 5, 257, 2),
         "shared_S111": (9, 32, 16, 111, 2), "shared_S7": (1000, 17, 3, 7, 3),
         "shared_S1000": (5, 2, 16, 1000, 2), "one_row": (1, 10, 5, 100, 4)}


@pytest.mark.parametrize("case", WALKS.values(), ids=WALKS.keys())
def test_every_row_and_sample_is_computed_and_stored_once(case):
    """Each (row, sample) is computed exactly once and stored exactly once,
    by the same block (the tile's values stay in its shared memory)."""
    N, d, K, S, grid = case
    plan = kernels.mc_plan(d, K, S, H100_SMEM)
    computed, stored = kernels.mc_work(N, S, plan, grid)
    want = sorted((r, s) for r in range(N) for s in range(S))
    assert sorted((r, s) for _, r, s in computed) == want
    assert sorted((r, s) for _, r, s in stored) == want
    assert sorted(computed) == sorted(stored)
