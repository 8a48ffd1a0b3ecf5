"""The plain reference: its model functions against autograd and the
closed forms, and against the port on the selections of each traffic mix
at a tiny size on the CPU (the whole run, window and check)."""

import math

import pytest
import torch

from benchmark.families import logreg, multiclass
from benchmark.tests.tiny import CELLS, tiny_run

MODELS = {"logreg": (logreg.reference_model({}), 4, 4),
          "multiclass": (multiclass.Model(3), 5, 12)}


def _rows(family: str, n: int, D: int, gen):
    z = torch.randn((n, D), generator=gen, dtype=torch.float64)
    if family == "multiclass":
        z[:, -1] = torch.randint(0, 3, (n,), generator=gen).to(torch.float64)
    return z


@pytest.mark.parametrize("family", sorted(MODELS))
def test_gradient_and_hessian_match_autograd(family):
    model, D, p = MODELS[family]
    gen = torch.Generator().manual_seed(3)
    z, w = _rows(family, 30, D, gen), torch.rand(30, generator=gen, dtype=torch.float64)
    th = torch.randn(p, generator=gen, dtype=torch.float64)
    f = lambda t: model.log_joint(z, t, w)
    assert torch.allclose(model.grad(z, th, w), torch.func.grad(f)(th), atol=1e-10)
    assert torch.allclose(model.hess(z, th, w), torch.func.hessian(f)(th), atol=1e-9)
    # a batch of candidates scores as each one alone
    cands = torch.stack([th, 2 * th])
    assert torch.allclose(model.log_joint(z, cands, w), torch.stack([f(th), f(2 * th)]))


def test_beta_likelihoods_match_their_definitions():
    gen = torch.Generator().manual_seed(4)
    beta = 0.3
    z, th = _rows("logreg", 7, 4, gen), torch.randn(5, 4, generator=gen, dtype=torch.float64)
    p = torch.sigmoid(z @ th.T)
    want = (beta + 1) / beta * p ** beta - p ** (beta + 1) - (1 - p) ** (beta + 1)
    assert torch.allclose(logreg.beta_likelihood(z, th, beta), want, atol=1e-12)
    model = multiclass.Model(3)
    z, th = _rows("multiclass", 7, 5, gen), torch.randn(5, 12, generator=gen,
                                                         dtype=torch.float64)
    P = torch.softmax(torch.einsum("nd,skd->nsk", z[:, :-1], th.reshape(5, 3, 4)), dim=-1)
    py = P.gather(2, z[:, -1].long()[:, None, None].expand(7, 5, 1))[:, :, 0]
    want = (beta + 1) / beta * py ** beta - (P ** (beta + 1)).sum(-1)
    assert torch.allclose(model.beta_likelihood(z, th, beta), want, atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_the_reference_at_a_tiny_size(cell):
    res = tiny_run(cell)
    assert res["correct"], res["readings"]
    for name, value in res["readings"].items():
        assert math.isfinite(value) and value < 1e-2, (name, value)
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"selection_ms", "peak_mem_gib", "setup_s"}
