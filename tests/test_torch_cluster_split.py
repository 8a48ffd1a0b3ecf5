"""How K1 and K3 split a step over their thread-block cluster, checked on the
CPU: the wrapper's cluster size (ops/kernels.py::cluster_size) and the row
split the kernels mirror (ops/kernels.py::cluster_rows,
csrc/logreg_common.cuh::RowSplit)."""

import pytest

from betacores_tpu_torch.ops import kernels

# (R, n_sub_pad, M_pad): the main path's, a (., 2) mesh's, the ragged ones
# of the card tests, a buffer smaller than the cluster and fewer rows than
# CTAs
SHAPES = {"main": (328, 200, 128), "mesh_2": (232, 104, 128), "ragged_19": (56, 37, 19),
          "ragged_9": (20, 11, 9), "M_pad_lt_C": (203, 200, 3), "R_lt_C": (3, 1, 2)}
# every cluster size the wrapper can choose
CLUSTERS = sorted({kernels.cluster_size(R) for R in range(1, 5000)})


def test_the_rule_chooses_sizes_2_to_16():
    assert CLUSTERS == [2, 4, 8, 16]


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_cluster_size_is_a_valid_cluster(shape):
    """1..16 CTAs, a power of two, the grid exactly one cluster (so the
    size divides it), and at most 24 rows per CTA below 16 CTAs."""
    R = shape[0]
    C = kernels.cluster_size(R)
    assert 1 <= C <= kernels.MAX_CLUSTER and C & (C - 1) == 0
    assert C == 16 or -(-R // C) <= 24
    assert C == 2 or -(-R // (C // 2)) > 24   # the smallest such size


def test_cluster_size_grows_with_the_rows():
    sizes = [kernels.cluster_size(R) for R in range(1, 2000)]
    assert sizes == sorted(sizes) and sizes[-1] == kernels.MAX_CLUSTER


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_every_row_and_slot_has_one_cta(shape, C):
    R, n_sub_pad, M_pad = shape
    split = kernels.cluster_rows(R, n_sub_pad, M_pad, C)
    assert len(split) == C
    rows = sorted(r for cta_rows, _ in split for r in cta_rows)
    slots = sorted(m for _, cta_slots in split for m in cta_slots)
    assert rows == list(range(R))
    assert slots == list(range(M_pad))


@pytest.mark.parametrize("C", CLUSTERS)
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_the_cta_of_a_slot_walks_its_core_row(shape, C):
    """CTA c keeps the centred core row of each slot it owns, at local row
    (its subsample rows) + j for its j-th slot, as the kernels index it;
    its subsample rows come first. CTAs without rows are allowed."""
    R, n_sub_pad, M_pad = shape
    for rows, slots in kernels.cluster_rows(R, n_sub_pad, M_pad, C):
        n_sub = len(rows) - len(slots)
        assert all(r < n_sub_pad for r in rows[:n_sub])
        assert rows[n_sub:] == [n_sub_pad + m for m in slots]


@pytest.mark.parametrize("C", CLUSTERS)
def test_interleaving_evens_the_live_rows(C):
    """At the main path's shape with 60 live slots (the rest of the 128
    masked), no CTA walks more than one live row above another."""
    R, n_sub_pad, M_pad = SHAPES["main"]
    live = [sum(1 for r in rows if r < n_sub_pad + 60)
            for rows, _ in kernels.cluster_rows(R, n_sub_pad, M_pad, C)]
    assert max(live) - min(live) <= 2


def test_cluster_rows_rejects_a_wrong_row_count():
    with pytest.raises(ValueError, match="n_sub_pad"):
        kernels.cluster_rows(10, 4, 5, 2)
