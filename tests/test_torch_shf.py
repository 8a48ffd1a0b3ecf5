"""The port's sparse Hamiltonian flows (betacores_tpu_torch/inference/shf.py)
against the JAX package's (betacores_tpu/inference/shf.py), in float64:
the flow and its log-determinant and the sampler under the JAX normals to
rtol 1e-10, and 10 Adam steps of the trainer under the JAX draws, rebuilt
from its keys (tests/torch_jax_mcmc.py), to rtol 1e-7 (Adam divides each
gradient by its own magnitude, so its low bits reach the parameters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference import shf as jshf
from betacores_tpu.models import logreg as jlogreg
from betacores_tpu_torch.inference import shf as tshf
from betacores_tpu_torch.models import logreg as tlogreg
from tests.torch_jax_mcmc import shf_draws

D, M, N = 3, 6, 120
CFG = jshf.SHFConfig(n_blocks=3, n_leapfrog=4, n_mc=5, n_batch=16, learning_rate=1e-2)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = np.where(rng.uniform(size=N) < 1 / (1 + np.exp(-X @ np.ones(D))), 1.0, -1.0)
    return y[:, None] * X


def _params(seed=1):
    """Init params, moved off their init so that every term is exercised."""
    rng = np.random.default_rng(seed)
    p = jshf.init_shf_params(jnp.asarray(_data()[:M]), D, N, CFG)
    return p._replace(w=p.w * jnp.asarray(rng.uniform(0.5, 1.5, M)),
                      a=jnp.asarray(0.1 * rng.normal(size=(CFG.n_blocks, D))),
                      b=jnp.asarray(0.1 * rng.normal(size=(CFG.n_blocks, D))),
                      mu0=jnp.asarray(0.3 * rng.normal(size=D)),
                      logs0=jnp.asarray(-0.5 + 0.1 * rng.normal(size=D)))


def _t(params):
    return tshf.SHFParams(*(torch.from_numpy(np.array(x)) for x in params))


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol,
                               err_msg=what)


def test_init_params_match_jax():
    pts = _data()[:M]
    got = tshf.init_shf_params(torch.from_numpy(pts), D, N, tshf.SHFConfig(**CFG._asdict()))
    for g, w in zip(got, jshf.init_shf_params(jnp.asarray(pts), D, N, CFG)):
        _close(g, w, 1e-15)


def test_flow_forward_and_log_det_match_jax():
    params = _params()
    rng = np.random.default_rng(2)
    th0, rho0 = rng.normal(size=(7, D)), rng.normal(size=(7, D))
    got = tshf._flow_forward(_t(params), tlogreg.log_joint, torch.from_numpy(th0),
                             torch.from_numpy(rho0), CFG)
    want = jax.vmap(lambda t, r: jshf._flow_forward(params, jlogreg.log_joint, t, r, CFG))(
        jnp.asarray(th0), jnp.asarray(rho0))
    _close(got[0], want[0], 1e-10, "theta")
    _close(got[1], want[1], 1e-10, "rho")
    _close(got[2], want[2][0], 1e-12, "log_det")


def test_shf_sample_matches_jax_under_its_normals():
    params = _params()
    key = jax.random.key(3)
    want = jshf.shf_sample(key, params, jlogreg.log_joint, 9, CFG)
    k_th, k_rho = jax.random.split(key)
    normals = (np.array(jax.random.normal(k_th, (9, D), dtype=jnp.float64)),
               np.array(jax.random.normal(k_rho, (9, D), dtype=jnp.float64)))
    got = tshf.shf_sample(normals, _t(params), tlogreg.log_joint, 9, CFG)
    for g, w, what in zip(got, want, ("theta", "rho", "log q")):
        _close(g, w, 1e-10, what)
    again = tshf.shf_sample(torch.Generator().manual_seed(0), _t(params), tlogreg.log_joint, 9,
                            CFG)
    assert again[0].shape == (9, D) and bool(torch.isfinite(again[2]).all())


@pytest.mark.parametrize("train_pts", [False, True])
def test_trainer_matches_jax(train_pts):
    cfg = CFG._replace(train_pts=train_pts)
    Z = _data()
    params = _params()
    key = jax.random.key(4)
    want_p, want_tr = jshf.make_shf_trainer(jnp.asarray(Z), jlogreg.log_joint, cfg)(key, params,
                                                                                   10)
    train = tshf.make_shf_trainer(torch.from_numpy(Z), tlogreg.log_joint,
                                  tshf.SHFConfig(**cfg._asdict()))
    got_p, got_tr = train(shf_draws(key, 10, N, D, cfg), _t(params), 10)
    _close(got_tr, want_tr, 1e-7, "elbo trace")
    for name, g, w in zip(tshf.SHFParams._fields, got_p, want_p):
        _close(g, w, 1e-7, name)
    assert torch.equal(got_p.pts, _t(params).pts) != train_pts
    assert float(got_p.w.min()) >= 0.0
    # a second call starts Adam afresh, as the reference's does
    again_p, _ = train(shf_draws(key, 10, N, D, cfg), _t(params), 10)
    for g, a in zip(got_p, again_p):
        assert torch.equal(g, a)


def test_trainer_on_the_ports_generator_raises_the_elbo():
    Z = torch.from_numpy(_data())
    train = tshf.make_shf_trainer(Z, tlogreg.log_joint, tshf.SHFConfig(**CFG._asdict()))
    params, trace = train(torch.Generator().manual_seed(0), _t(_params()), 60)
    assert trace.shape == (60,) and bool(torch.isfinite(trace).all())
    assert float(trace[-10:].mean()) > float(trace[:10].mean())


def test_beta_and_gaussian_log_joints_match_jax():
    rng = np.random.default_rng(5)
    Z, w = _data()[:20], rng.uniform(0.5, 2.0, 20)
    ths = rng.normal(size=(4, D))
    tb = tshf.beta_log_joint(tlogreg.bundle(), 0.3)
    jb = jshf.beta_log_joint(jlogreg.bundle(), 0.3)
    Siginv = np.linalg.inv(np.eye(D) + 0.3 * np.ones((D, D)))
    mu0, S0 = rng.normal(size=D), 2.0 * np.eye(D)
    tg = tshf.gaussian_log_joint(torch.from_numpy(Siginv), torch.from_numpy(mu0),
                                 torch.from_numpy(S0))
    jg = jshf.gaussian_log_joint(jnp.asarray(Siginv), jnp.asarray(mu0), jnp.asarray(S0))
    tg0, jg0 = tshf.gaussian_log_joint(torch.from_numpy(Siginv)), jshf.gaussian_log_joint(
        jnp.asarray(Siginv))
    Zt, wt = torch.from_numpy(Z), torch.from_numpy(w)
    for t_lj, j_lj in ((tb, jb), (tg, jg), (tg0, jg0)):
        want = np.asarray([j_lj(jnp.asarray(Z), jnp.asarray(t), jnp.asarray(w)) for t in ths])
        _close(t_lj(Zt, torch.from_numpy(ths), wt), want, 1e-12)
        _close(t_lj(Zt, torch.from_numpy(ths[0]), wt), want[0], 1e-12)


def test_sharded_trainer_names_its_roadmap_item():
    """``make_sharded_shf_trainer`` is ported (tests/test_torch_sharded_lanes.py):
    it refuses a missing mesh, and n_mc lanes that do not split evenly over
    the mesh's ranks (the JAX one's ``n_mc % P`` check)."""
    with pytest.raises(ValueError, match="mesh must have axes"):
        tshf.make_sharded_shf_trainer(torch.zeros((4, D)), tlogreg.log_joint, None)

    class ThreeRanks:
        shape = {"data": 3, "samp": 1}

    with pytest.raises(ValueError, match="must divide over 3 ranks"):
        tshf.make_sharded_shf_trainer(torch.zeros((4, D)), tlogreg.log_joint, ThreeRanks(),
                                      tshf.SHFConfig(n_mc=5))
