"""The port's neural-linear model (betacores_tpu_torch/models/neural_linear.py)
against the JAX package's (betacores_tpu/models/neural_linear.py), on the
CPU, at a small size (d = 4 inputs, F = 6 features, n <= 80 rows).

The JAX model's parameters are carried across with
``encoder_state_from_flax``, and its minibatch orders, which it draws from
its own key, are rebuilt from that key and fed to the port's ``optimize``.
Tolerances: the closed-form last layer, the predictive and the log
densities in float64 within rtol 1e-10; the encoder's forward (eval and
train) and its running statistics in float32 within rtol 1e-5, atol 1e-6;
the schedule within rtol 1e-12 of optax's (both float64 here); a whole
5-epoch training in float32 within rtol 2e-4, atol 2e-5 (per-epoch losses
and final parameters: float32 Adam over 10 steps, each the two
implementations' own rounding of the same ``inv`` and reductions).

Two parts of the trained state are left out of that comparison, in both
implementations alike: each Linear bias feeds a BatchNorm that in train
mode subtracts the batch mean, so its gradient is zero but for rounding,
and Adam turns that rounding into steps of up to the learning rate whose
sign is the rounding's; the running means track those biases. The test
bounds them by Adam's step instead, and holds ``test()`` of the JAX
model's trained state loaded into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from betacores_tpu.models import neural_linear as jnl
from betacores_tpu_torch.models import neural_linear as tnl

torch.set_num_threads(1)

D_IN, F, N = 4, 6, 80


def _problem(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D_IN))
    y = np.sin(X[:, :1]) + X[:, 1:2] * X[:, 2:3] + 0.1 * rng.normal(size=(n, 1))
    return np.hstack([X, y]).astype(np.float32)


def _pair(Z_init, student_t=False, seed=3, sigmasq=0.5):
    """The JAX model and the port's under the JAX model's parameters."""
    j = jnl.NeuralLinear(Z_init, out_features=F, sigmasq=sigmasq, student_t=student_t,
                         seed=seed, output_mean=0.3, output_std=2.0)
    t = tnl.NeuralLinear(Z_init, out_features=F, sigmasq=sigmasq, student_t=student_t,
                         seed=seed, output_mean=0.3, output_std=2.0, device="cpu")
    t.variables = tnl.encoder_state_from_flax(_np_vars(j.variables), device="cpu")
    return j, t


def _np_vars(v):
    return jax.tree.map(np.asarray, dict(v))


def _jax_perms(key, num_epochs, n):
    """The per-epoch permutations the JAX ``optimize`` draws next."""
    _, k = jax.random.split(key)
    return np.stack([np.asarray(jax.random.permutation(kk, n))
                     for kk in jax.random.split(k, num_epochs)])


# --- the closed-form last layer ------------------------------------------------


@pytest.mark.parametrize("student_t", [False, True])
def test_posteriors_predictive_and_densities_match_jax(student_t):
    rng = np.random.default_rng(1)
    X, y, Xq = rng.normal(size=(40, F)), rng.normal(size=(40, 1)), rng.normal(size=(7, F))
    yq = rng.normal(size=(7, 1))
    if student_t:
        jl = jnl.full_bayesian_regression_posterior(jnp.asarray(X), jnp.asarray(y), 1.5, 0.7, 2.0)
        tl = tnl.full_bayesian_regression_posterior(torch.from_numpy(X), torch.from_numpy(y),
                                                    1.5, 0.7, 2.0)
        for a, b in ((tl.a_tilde, jl.a_tilde), (tl.b_tilde, jl.b_tilde), (tl.nu, jl.nu)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)
    else:
        jl = jnl.bayesian_regression_posterior(jnp.asarray(X), jnp.asarray(y), 0.5, 2.0)
        tl = tnl.bayesian_regression_posterior(torch.from_numpy(X), torch.from_numpy(y),
                                               0.5, 2.0)
        assert tl.nu is None
    np.testing.assert_allclose(tl.theta_mean.numpy(), np.asarray(jl.theta_mean), rtol=1e-10)
    np.testing.assert_allclose(tl.theta_cov.numpy(), np.asarray(jl.theta_cov), rtol=1e-10)
    jm, jv = jnl.predictive(jl, jnp.asarray(Xq), 0.5)
    tm, tv = tnl.predictive(tl, torch.from_numpy(Xq), 0.5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-10)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)
    assert tv.shape == (7, 1)
    np.testing.assert_allclose(
        tnl.gaussian_log_density(torch.from_numpy(yq), tm, tv).numpy(),
        np.asarray(jnl.gaussian_log_density(jnp.asarray(yq), jm, jv)), rtol=1e-10)
    nu = 7.5
    np.testing.assert_allclose(
        tnl.students_t_log_density(torch.from_numpy(yq), tm, tv,
                                   torch.tensor(nu, dtype=torch.float64)).numpy(),
        np.asarray(jnl.students_t_log_density(jnp.asarray(yq), jm, jv, nu)), rtol=1e-10)


# --- the encoder ---------------------------------------------------------------


def test_encoder_forward_and_running_stats_match_flax():
    """Eval mode, train mode (batch statistics), and the running statistics
    after one train-mode pass, under the flax parameters; the state carried
    across and back is the same arrays."""
    Z = _problem()
    j, t = _pair(Z[:50])
    v = j.variables
    # make the running statistics non-trivial first
    _, mut = j.module.apply(v, jnp.asarray(Z[:, :-1]) * 2.0 + 0.5, train=True,
                            mutable=["batch_stats"])
    v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    state = tnl.encoder_state_from_flax(_np_vars(v), device="cpu")
    back = tnl.encoder_state_to_numpy(state)
    jax.tree.map(np.testing.assert_array_equal, back, _np_vars(v))
    x = Z[:30, :-1]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tnl.apply_encoder(state, torch.from_numpy(x))[0].numpy(),
                               np.asarray(j.module.apply(v, jnp.asarray(x))), **tol)
    jf, jmut = j.module.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tf, stats = tnl.apply_encoder(state, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **tol)
    tnl.update_running_stats(state, stats)
    want = _np_vars({"params": v["params"], "batch_stats": jmut["batch_stats"]})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **tol),
                 tnl.encoder_state_to_numpy(state), want)


def test_encoder_initialisation_is_flax_like():
    """LeCun truncated-normal kernels (|w| <= 2 std, the truncated draw's
    spread 1/fan_in), zero biases, unit scales, statistics 0 and 1."""
    enc = tnl.Encoder(40, 64)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    for i, fan_in in ((0, 40), (1, 64)):
        w = getattr(enc, f"dense{i}").weight.detach()
        std = (1.0 / fan_in) ** 0.5 / tnl._TRUNC_STD
        assert float(w.abs().max()) <= 2.0 * std
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1
        assert not getattr(enc, f"dense{i}").bias.detach().any()
        norm = getattr(enc, f"norm{i}")
        assert (norm.weight == 1).all() and not norm.bias.detach().any()
        assert not norm.running_mean.any() and (norm.running_var == 1).all()


def test_schedule_mask_and_batch_size_match_the_reference():
    for lr, steps in ((1e-2, 600), (3e-3, 7)):
        sched = optax.cosine_decay_schedule(lr, steps, alpha=1e-5 / lr)
        for t in range(steps + 3):
            assert tnl.cosine_decay_lr(lr, steps, t, 1e-5 / lr) == pytest.approx(
                float(sched(t)), rel=1e-12)
    j, t = _pair(_problem()[:20])
    jmask = jnl._mask_kernels(j.variables["params"])
    want = {}
    for layer, leaves in jmask.items():
        i = layer.split("_")[1]
        pre = "dense" if layer.startswith("Dense") else "norm"
        for leaf, decayed in leaves.items():
            want[f"{pre}{i}.{'weight' if leaf in ('kernel', 'scale') else 'bias'}"] = decayed
    assert tnl.decay_mask(t.module) == want
    for n in range(1, 1101):
        assert tnl.batch_size_pow2(n) == jnl._batch_size_pow2(n), n


# --- training ----------------------------------------------------------------


@pytest.mark.parametrize("student_t", [False, True])
def test_optimize_matches_jax_under_its_orders(student_t):
    """One 5-epoch ``optimize`` on a 40-row weighted coreset (batch 16, 2
    minibatches an epoch) from the JAX initial parameters under the JAX
    permutations: the same per-epoch losses and final state; ``test()``
    before and after agrees too."""
    Z = _problem(2)
    Zc = Z[:40]
    w = np.random.default_rng(5).uniform(0.5, 3.0, size=40).astype(np.float32)
    j, t = _pair(Zc, student_t=student_t)
    Ztest = Z[40:]
    for got, want in zip(t.test(Ztest), j.test(jnp.asarray(Ztest))):
        assert got == pytest.approx(want, rel=1e-5)
    perms = _jax_perms(j._key, 5, 40)
    jl = j.optimize(w, Zc, num_epochs=5, initial_lr=1e-2, weight_decay=0.1)
    tl = t.optimize(w, Zc, num_epochs=5, initial_lr=1e-2, weight_decay=0.1, perms=perms)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tl, jl, **tol)
    assert not np.allclose(tl[0], tl[-1])               # the training moved the loss
    got, want = tnl.encoder_state_to_numpy(t.variables), _np_vars(j.variables)
    init = _np_vars(jnl.NeuralLinear(Zc, out_features=F, seed=3).variables)
    for i in range(2):
        dense, norm = f"Dense_{i}", f"BatchNorm_{i}"
        np.testing.assert_allclose(got["params"][dense]["kernel"],
                                   want["params"][dense]["kernel"], **tol)
        for leaf in ("scale", "bias"):
            np.testing.assert_allclose(got["params"][norm][leaf], want["params"][norm][leaf],
                                       **tol)
        np.testing.assert_allclose(got["batch_stats"][norm]["var"],
                                   want["batch_stats"][norm]["var"], **tol)
        # the rounding-driven biases: at most one learning rate a step from 0
        for v in (got, want):
            moved = np.abs(v["params"][dense]["bias"] - init["params"][dense]["bias"])
            assert moved.max() <= 1e-2 * 10
    t.variables = tnl.encoder_state_from_flax(want, device="cpu")
    for a, b in zip(t.test(Ztest), j.test(jnp.asarray(Ztest))):
        assert a == pytest.approx(b, rel=1e-5)


def test_optimize_draws_its_own_orders_and_forward_matches():
    """Without ``perms`` the port draws its orders from its generator: two
    models of one seed train alike; ``encode`` and ``forward`` equal the
    JAX model's under the same parameters."""
    Z = _problem(4)
    runs = []
    for _ in range(2):
        t = tnl.NeuralLinear(Z[:32], out_features=F, sigmasq=0.5, seed=8, device="cpu")
        runs.append(t.optimize(np.ones(32), Z[:32], num_epochs=3))
    np.testing.assert_array_equal(*runs)
    j, t = _pair(Z[:32])
    np.testing.assert_allclose(t.encode(Z[:, :-1]).numpy(),
                               np.asarray(j.encode(jnp.asarray(Z[:, :-1]))), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(t.forward(Z[:9, :-1]), j.forward(jnp.asarray(Z[:9, :-1]))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
