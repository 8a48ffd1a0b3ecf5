"""The port's group data valuation (betacores_tpu_torch/valuation/shapley.py)
against the JAX package's, on the CPU, in float64 (the conftest's x64 for
the JAX side).

The permutations, the cap's uniforms and every prefix's posterior noise
are rebuilt from the JAX estimator's key in its key-split recipe
(split(key, T); per round split(., 3) into permutation, cap and value
keys; the value noise of prefix j from fold_in(value key, j)) and injected
into the port (``PermutationDraws``). The Laplace fits then agree to
rounding, so the accuracies agree exactly unless a test score sits within
rounding of 0: the estimates are held within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets.groups import group_ids_from_groups as j_gids
from betacores_tpu.ops.projection import Groups as JGroups
from betacores_tpu.valuation import capped_member_mask as j_capped
from betacores_tpu.valuation import logreg_laplace_value_fn as j_value_fn
from betacores_tpu.valuation import make_dshapley as j_dshapley
from betacores_tpu.valuation import make_tmc_shapley as j_tmc
from betacores_tpu_torch.coresets import group_ids_from_groups
from betacores_tpu_torch.ops.projection import Groups
from betacores_tpu_torch.valuation import (capped_member_mask, logreg_laplace_value_fn,
                                           make_dshapley, make_tmc_shapley)
from betacores_tpu_torch.valuation.shapley import PermutationDraws

torch.set_num_threads(1)

G, PER, D, N_SAMPLES = 6, 25, 4, 64


@pytest.fixture(scope="module")
def problem():
    """tests/test_valuation.py's: 6 groups of 25 rows, groups 4 and 5 with
    every label flipped, and 400 test rows."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(G * PER, D))
    th_true = np.ones(D)
    y = np.where(rng.uniform(size=G * PER) < 1 / (1 + np.exp(-X @ th_true)), 1.0, -1.0)
    groups = [list(range(g * PER, (g + 1) * PER)) for g in range(G)]
    for g in (4, 5):
        y[groups[g]] = -y[groups[g]]
    Z = y[:, None] * X
    Xt = rng.normal(size=(400, D))
    yt = np.where(rng.uniform(size=400) < 1 / (1 + np.exp(-Xt @ th_true)), 1.0, -1.0)
    return Z, Xt, yt, groups


def _port(problem, group_lists=None):
    Z, Xt, yt, groups = problem
    gp = Groups.from_lists(group_lists or groups, device="cpu")
    gid = group_ids_from_groups(gp, Z.shape[0])
    return gp, gid, tuple(torch.from_numpy(a) for a in (Z, Xt, yt))


def _jax(problem, group_lists=None):
    Z, Xt, yt, groups = problem
    gp = JGroups.from_lists(group_lists or groups)
    return gp, j_gids(gp, Z.shape[0]), tuple(jnp.asarray(a) for a in (Z, Xt, yt))


def jax_rounds(key, T, groups, n_prefixes, capped):
    """The draws of T rounds of the JAX estimators from ``key``."""
    out = []
    L = max(len(g) for g in groups)
    for k in jax.random.split(key, T):
        kp, kc, kv = jax.random.split(k, 3)
        perm = jax.random.permutation(kp, len(groups))
        cap_u = jax.random.uniform(kc, (len(groups), L)) if capped else None
        noise = jnp.stack([jax.random.normal(jax.random.fold_in(kv, j), (N_SAMPLES, D),
                                             dtype=jnp.float64)
                           for j in range(n_prefixes)])
        out.append(PermutationDraws(torch.from_numpy(np.array(perm)).long(),
                                    None if cap_u is None else torch.from_numpy(np.array(cap_u)),
                                    torch.from_numpy(np.array(noise))))
    return out


def test_capped_member_mask_matches_jax():
    """At most cap members a group (all of a smaller group), the JAX mask
    under the JAX uniforms; the padding row N - 1 stays off unless chosen."""
    lists = [[0, 1, 2, 3, 4], [5, 6], [7, 8, 9]]
    key = jax.random.key(0)
    want = np.asarray(j_capped(key, JGroups.from_lists(lists), 2, 11))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (3, 5))))
    got = capped_member_mask(u, Groups.from_lists(lists, device="cpu"), 2, 11).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:5].sum() == 2 and got[5:7].sum() == 2 and got[7:10].sum() == 2
    assert not got[10]
    own = capped_member_mask(torch.Generator().manual_seed(1),
                             Groups.from_lists(lists, device="cpu"), 2, 11).numpy()
    assert own[:5].sum() == 2 and not own[10]
    assert capped_member_mask(None, Groups.from_lists(lists, device="cpu"), None, 11).all()


@pytest.mark.parametrize("cap", [None, 10])
def test_dshapley_matches_jax_under_jax_draws(problem, cap):
    """Distributional Shapley over the first 4 prefixes of 6 permutations."""
    T, mg, key = 6, 4, jax.random.key(0)
    jgp, jgid, jargs = _jax(problem)
    want = np.asarray(j_dshapley(jgid, jgp, j_value_fn(n_samples=N_SAMPLES), max_groups=mg,
                                 group_cap=cap, value_args=jargs)(key, T))
    gp, gid, args = _port(problem)
    dshap = make_dshapley(gid, gp, logreg_laplace_value_fn(n_samples=N_SAMPLES), max_groups=mg,
                          group_cap=cap, value_args=args)
    got = dshap(jax_rounds(key, T, problem[3], mg, cap is not None), T).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() > 0


def test_tmc_shapley_matches_jax_and_skips_truncated_fits(problem):
    """TMC under the JAX draws: the same estimate, and a truncated prefix
    is not fitted (fewer fits than T * G)."""
    T, key, tol = 5, jax.random.key(1), 0.02
    jgp, jgid, jargs = _jax(problem)
    full = float(j_value_fn(n_samples=N_SAMPLES)(jax.random.key(9), jnp.ones(G * PER,
                                                                             jnp.float32),
                                                 *jargs))
    want = np.asarray(j_tmc(jgid, jgp, j_value_fn(n_samples=N_SAMPLES), full_value=full,
                            tol=tol, value_args=jargs)(key, T))
    gp, gid, args = _port(problem)
    value_fn = logreg_laplace_value_fn(n_samples=N_SAMPLES)
    calls = [0]

    class Counted:
        draw = value_fn.draw

        def __call__(self, *a):
            calls[0] += 1
            return value_fn(*a)

    tmc = make_tmc_shapley(gid, gp, Counted(), full_value=full, tol=tol, value_args=args)
    got = tmc(jax_rounds(key, T, problem[3], G, False), T).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0 < calls[0] < T * G


def test_value_fn_matches_jax(problem):
    """The Laplace-accuracy value of a half-membership vector under the
    same noise."""
    Z, Xt, yt, _ = problem
    w = (np.arange(G * PER) % 2).astype(np.float32)
    key = jax.random.key(4)
    want = float(j_value_fn(n_samples=N_SAMPLES)(key, jnp.asarray(w), jnp.asarray(Z),
                                                 jnp.asarray(Xt), jnp.asarray(yt)))
    z = torch.from_numpy(np.array(jax.random.normal(key, (N_SAMPLES, D), dtype=jnp.float64)))
    got = float(logreg_laplace_value_fn(n_samples=N_SAMPLES)(
        z, torch.from_numpy(w), *(torch.from_numpy(a) for a in (Z, Xt, yt))))
    assert got == pytest.approx(want, abs=1e-12)


def test_own_stream_ranks_the_corrupted_groups_lowest(problem):
    """On the port's own draws both estimators rank the two corrupted
    groups lowest (tests/test_valuation.py's property)."""
    gp, gid, args = _port(problem)
    value_fn = logreg_laplace_value_fn(n_samples=N_SAMPLES)
    phis = make_dshapley(gid, gp, value_fn, max_groups=G, value_args=args)(
        torch.Generator().manual_seed(0), 20).numpy()
    assert set(np.argsort(phis)[:2].tolist()) == {4, 5}, phis
    full = float(value_fn(torch.randn((N_SAMPLES, D), generator=torch.Generator().manual_seed(9),
                                      dtype=torch.float64),
                          torch.ones(G * PER), *args))
    tmc = make_tmc_shapley(gid, gp, value_fn, full_value=full, tol=0.005, value_args=args)
    phis = tmc(torch.Generator().manual_seed(1), 10).numpy()
    assert phis[[0, 1, 2, 3]].mean() > phis[[4, 5]].mean(), phis


def test_mesh_names_its_roadmap_item(problem):
    gp, gid, args = _port(problem)
    for make in (lambda: make_dshapley(gid, gp, logreg_laplace_value_fn(), 3, mesh=object(),
                                       value_args=args),
                 lambda: make_tmc_shapley(gid, gp, logreg_laplace_value_fn(), 0.9,
                                          mesh=object(), value_args=args)):
        with pytest.raises(NotImplementedError, match="item 12"):
            make()
