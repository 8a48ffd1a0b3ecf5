"""Each family's closed-form beta-gradient (the bundles' ``beta_gradient``)
against the forward-mode derivative of its own ``beta_likelihood``
(``models.base.beta_gradient_from_autodiff``, torch.func.jvp) and against
the JAX bundle's (jax.jvp, betacores_tpu/models/base.py), on the same rows
and samples made from a numpy seed: logistic, multiclass, the
known-covariance Gaussian, linear regression, neural-linear (linear
regression over a small flax encoder's features, carried across with
``encoder_state_from_flax``), Poisson in both mass modes and the
unknown-covariance Gaussian, at beta in {1e-3, 0.1, 0.5, 1.0} given as a
float and as a 0-d tensor.

Tolerances: rtol 1e-10 in float64 and 1e-5 in float32, elementwise, with an
absolute floor of ten ulps of the block's largest value. The closed form
and the JVP sum the same terms in another order, so an element where the
terms cancel to near 0 keeps their rounding, a few ulps of the largest
term (at beta = 1e-3 the -1/beta^2 term is 1e6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.models import gaussian as jg
from betacores_tpu.models import linreg as jl
from betacores_tpu.models import logreg as jlr
from betacores_tpu.models import multiclass as jmc
from betacores_tpu.models import mvn as jm
from betacores_tpu.models import neural_linear as jnl
from betacores_tpu.models import poisson as jp
from betacores_tpu_torch.models import gaussian, linreg, logreg, multiclass, mvn, neural_linear
from betacores_tpu_torch.models import poisson
from betacores_tpu_torch.models.base import beta_gradient_from_autodiff

torch.set_num_threads(1)

N, S, D, K, F, SIGSQ = 40, 7, 3, 4, 5, 0.7
BETAS = (1e-3, 0.1, 0.5, 1.0)
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _encoder(dtype):
    """A flax encoder's variables (its running statistics moved off their
    initial values) and the port's copy, both in ``dtype``."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, D)).astype(np.float32)
    module = jnl.Encoder(out_features=F)
    v = module.init(jax.random.key(0), x)
    v = {"params": v["params"],
         "batch_stats": jax.tree.map(lambda a: a + 0.1 * jnp.ones_like(a), v["batch_stats"])}
    v = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), v)
    ctx = neural_linear.encoder_state_from_flax(jax.tree.map(np.asarray, v), device="cpu")
    ctx = {k: t.to(dtype) for k, t in ctx.items()}
    return module, v, ctx


def _family(name, dtype):
    """(port bundle, JAX bundle, rows, samples) of one family, the arrays
    in numpy."""
    rng = np.random.default_rng(FAMILIES.index(name))
    if name == "logreg":
        return logreg.bundle(), jlr.bundle(fused=False), rng.normal(size=(N, D)), \
            rng.normal(size=(S, D))
    if name == "multiclass":
        Z = np.c_[rng.normal(size=(N, D)), rng.integers(0, K, N)]
        return multiclass.bundle(K, fused=False), jmc.bundle(K, fused=False), Z, \
            rng.normal(size=(S, K * D))
    if name == "gaussian":
        Sig = np.eye(D) + 0.3 * np.ones((D, D))
        Si, ld = np.linalg.inv(Sig), float(np.linalg.slogdet(Sig)[1])
        return gaussian.bundle(torch.tensor(Si, dtype=dtype), ld), \
            jg.bundle(jnp.asarray(Si, JDT[dtype]), ld), rng.normal(size=(N, D)), \
            rng.normal(size=(S, D))
    if name == "linreg":
        Z = np.c_[rng.normal(size=(N, D)), rng.normal(size=N)]
        return linreg.bundle(SIGSQ), jl.bundle(SIGSQ), Z, rng.normal(size=(S, D))
    if name == "neural_linear":
        module, v, ctx = _encoder(dtype)
        enc = neural_linear.Encoder(D, F)
        Z = np.c_[rng.normal(size=(N, D)), rng.normal(size=N)]
        return neural_linear.neural_linear_model_factory(enc, SIGSQ)(ctx), \
            jnl.neural_linear_model_factory(module, SIGSQ)(v), Z, rng.normal(size=(S, F))
    if name.startswith("poisson"):
        gm = name == "poisson_gaussian_mass"
        Z = np.c_[0.5 * rng.normal(size=(N, D)), rng.poisson(3.0, N)]
        return (poisson.bundle(k_max=40, gaussian_mass=gm),
                jp.bundle(k_max=40, gaussian_mass=gm), Z, 0.5 * rng.normal(size=(S, D)))
    assert name == "mvn"
    L = np.tril(0.2 * rng.normal(size=(S, D, D)), -1) + np.eye(D) * rng.uniform(0.7, 1.3,
                                                                                 size=(S, 1, D))
    return mvn.bundle(D), jm.bundle(D), rng.normal(size=(N, D)), \
        np.c_[rng.normal(size=(S, D)), L.reshape(S, -1)]


FAMILIES = ("logreg", "multiclass", "gaussian", "linreg", "neural_linear", "poisson_exact_mass",
            "poisson_gaussian_mass", "mvn")


def _close(got, want, dtype, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 10 * np.finfo(np.float64 if dtype == torch.float64 else np.float32).eps
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=floor * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("name", FAMILIES)
def test_closed_form_matches_both_forward_mode_derivatives(name, dtype, beta):
    tb, jb, Z, TH = _family(name, dtype)
    assert not getattr(tb.beta_gradient, "forward_mode", False)
    z, th = torch.tensor(Z, dtype=dtype), torch.tensor(TH, dtype=dtype)
    jvp = beta_gradient_from_autodiff(tb.beta_likelihood)
    assert jvp.forward_mode
    want_jax = np.asarray(jb.beta_gradient(jnp.asarray(Z, JDT[dtype]),
                                           jnp.asarray(TH, JDT[dtype]), beta))
    for b in (beta, torch.tensor(beta, dtype=dtype)):
        got = tb.beta_gradient(z, th, b)
        assert got.shape == (N, S) and got.dtype == dtype
        what = f"{name} beta={beta} as {type(b).__name__}"
        _close(got.numpy(), jvp(z, th, b).numpy(), dtype, what + " against torch.func.jvp")
        _close(got.numpy(), want_jax, dtype, what + " against jax.jvp")


def test_poisson_exact_mass_gradient_over_several_chunks(monkeypatch):
    """The exact mass term's gradient in row chunks (a budget of 7 rows'
    worth of elements, so 40 rows take 6 chunks) equals the one-chunk
    result bit for bit, and the forward-mode derivative over those chunks."""
    tb, _, Z, TH = _family("poisson_exact_mass", torch.float64)
    z, th = torch.tensor(Z), torch.tensor(TH)
    beta = torch.tensor(0.3, dtype=torch.float64)
    one = tb.beta_gradient(z, th, beta)
    monkeypatch.setattr(poisson, "MASS_CHUNK_ELEMENTS", 7 * S * 41)
    chunked = tb.beta_gradient(z, th, beta)
    assert torch.equal(chunked, one)
    _close(chunked.numpy(), beta_gradient_from_autodiff(tb.beta_likelihood)(z, th, beta).numpy(),
           torch.float64, "chunked")


def test_closed_form_is_not_the_normalised_reference_gradient():
    """The Gaussian bundle's closed form differentiates the beta-likelihood
    it projects (the dropped-constant form), not ``beta_gradient_reference``,
    which keeps the normaliser terms."""
    tb, _, Z, TH = _family("gaussian", torch.float64)
    z, th = torch.tensor(Z), torch.tensor(TH)
    Sig = np.eye(D) + 0.3 * np.ones((D, D))
    ref = gaussian.beta_gradient_reference(z, th, 0.5, torch.tensor(np.linalg.inv(Sig)),
                                           float(np.linalg.slogdet(Sig)[1]))
    assert not torch.allclose(tb.beta_gradient(z, th, 0.5), ref)
