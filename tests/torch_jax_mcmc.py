"""The JAX package's MCMC and flow draws, rebuilt from its keys in its own
key layout, as the port's injected draws objects (for the tests of
betacores_tpu_torch/inference/hmc.py, nuts.py and shf.py).

HMC (betacores_tpu/inference/hmc.py): chain c of ``run_chains`` runs on
``split(key, C)[c]``, its init jitter is ``normal(fold_in(key, 99), (C, d))``;
warmup A, warmup B and sampling split ``fold_in(k, 0)``, ``fold_in(k, 2)``
and ``fold_in(k, 1)`` into one key an iteration; an iteration splits
``k_traj, k_L``, draws L from k_L, splits k_traj into ``k_mom, k_sel,
k_off``, draws j from k_off and one reservoir uniform per step from
``split(k_sel, L_max)``. NUTS (nuts.py): an iteration splits ``k_mom,
k_loop``; doubling t splits ``k, k_dir, k_sub, k_swap = split(k, 4)`` and
its leaves ``k, k_take = split(k)`` from k_sub. SHF (shf.py): step keys
``split(key, n_steps)``, each ``k_s, k_b``, with ``k_th, k_rho`` from k_s;
the sharded trainer folds the device index into each step key first.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from betacores_tpu_torch.inference import (HMCDraws, HMCPhaseDraws, NUTSDraws, NUTSPhaseDraws,
                                           SHFDraws)

# warmup A, warmup B, sampling: their fold_in tags
PHASE_TAGS = (0, 2, 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _phase_lengths(cfg):
    n_a = cfg.n_warmup // 2
    return n_a, cfg.n_warmup - n_a, cfg.n_samples


@partial(jax.jit, static_argnums=(1, 2))
def _hmc_iteration(k, d, L_max):
    k_traj, k_L = jax.random.split(k)
    L = jax.random.randint(k_L, (), 1, L_max + 1)
    k_mom, k_sel, k_off = jax.random.split(k_traj, 3)
    z = jax.random.normal(k_mom, (d,), dtype=jnp.float64)
    j = jax.random.randint(k_off, (), 0, L + 1)
    u = jax.vmap(jax.random.uniform)(jax.random.split(k_sel, L_max))
    return z, L, j, u


def hmc_iteration_draws(keys, d: int, L_max: int) -> tuple:
    """(z, L, j, u) of the iterations of ``keys`` (any leading shape)."""
    f = partial(_hmc_iteration, d=d, L_max=L_max)
    for _ in range(keys.ndim):
        f = jax.vmap(f)
    return tuple(np.asarray(x) for x in f(keys))


def _phase_keys(chain_keys, tag: int, n: int):
    return jax.vmap(lambda kc: jax.random.split(jax.random.fold_in(kc, tag), n))(chain_keys)


def _init(key, C: int, d: int):
    return _t(jax.random.normal(jax.random.fold_in(key, 99), (C, d), dtype=jnp.float64))


def hmc_draws(key, C: int, d: int, cfg, chains: bool = True) -> HMCDraws:
    """The draws of ``run_chains(key, ..., C, cfg)`` (``chains``) or of
    ``hmc_sample(key, ...)`` (one chain on the key itself)."""
    chain_keys = jax.random.split(key, C) if chains else key[None]
    phases = []
    for tag, n in zip(PHASE_TAGS, _phase_lengths(cfg)):
        z, L, j, u = hmc_iteration_draws(_phase_keys(chain_keys, tag, n), d, cfg.L_max)
        sw = lambda x: _t(np.swapaxes(x, 0, 1))           # (C, n, ...) -> (n, C, ...)
        phases.append(HMCPhaseDraws(sw(z), sw(L).long(), sw(j).long(), sw(u)))
    return HMCDraws(_init(key, C, d) if chains else None, tuple(phases))


@partial(jax.jit, static_argnums=(1, 2))
def _nuts_iteration(k, d, T):
    k_mom, kk = jax.random.split(k)
    z = jax.random.normal(k_mom, (d,), dtype=jnp.float64)
    rights, swaps, leaves = [], [], []
    for t in range(T):
        kk, k_dir, k_sub, k_swap = jax.random.split(kk, 4)
        rights.append(jax.random.bernoulli(k_dir))
        swaps.append(jax.random.uniform(k_swap, dtype=jnp.float64))

        def leaf(k, _):
            k, k_take = jax.random.split(k)
            return k, jax.random.uniform(k_take, dtype=jnp.float64)

        _, u = jax.lax.scan(leaf, k_sub, None, length=2 ** t)
        leaves.append(u)
    return z, jnp.stack(rights), jnp.stack(swaps), jnp.concatenate(leaves)


def nuts_iteration_draws(keys, d: int, T: int) -> tuple:
    """(z, right, swap, leaf) of the NUTS iterations of ``keys``."""
    f = partial(_nuts_iteration, d=d, T=T)
    for _ in range(keys.ndim):
        f = jax.vmap(f)
    return tuple(np.asarray(x) for x in f(keys))


def nuts_draws(key, C: int, d: int, cfg, chains: bool = True) -> NUTSDraws:
    """The draws of ``run_chains_nuts(key, ..., C, cfg)`` or of
    ``nuts_sample(key, ...)``."""
    chain_keys = jax.random.split(key, C) if chains else key[None]
    phases = []
    for tag, n in zip(PHASE_TAGS, _phase_lengths(cfg)):
        z, right, swap, leaf = nuts_iteration_draws(_phase_keys(chain_keys, tag, n), d,
                                                    cfg.max_treedepth)
        sw = lambda x: _t(np.swapaxes(x, 0, 1))
        phases.append(NUTSPhaseDraws(sw(z), sw(right), sw(swap), sw(leaf)))
    return NUTSDraws(_init(key, C, d) if chains else None, tuple(phases))


def _shf_step_draws(keys, N: int, d: int, cfg) -> SHFDraws:
    def one(k):
        k_s, k_b = jax.random.split(k)
        k_th, k_rho = jax.random.split(k_s)
        return (jax.random.normal(k_th, (cfg.n_mc, d), dtype=jnp.float64),
                jax.random.normal(k_rho, (cfg.n_mc, d), dtype=jnp.float64),
                jax.random.randint(k_b, (cfg.n_batch,), 0, N))

    z_th, z_rho, idx = jax.jit(jax.vmap(one))(keys)
    return SHFDraws(_t(z_th), _t(z_rho), _t(idx).long())


def shf_draws(key, n_steps: int, N: int, d: int, cfg) -> SHFDraws:
    """The draws of ``make_shf_trainer(...)(key, params, n_steps)``."""
    return _shf_step_draws(jax.random.split(key, n_steps), N, d, cfg)


def sharded_shf_draws(key, n_steps: int, N: int, d: int, cfg, n_dev: int) -> list:
    """Each device's draws of ``make_sharded_shf_trainer(...)(key, params,
    n_steps)`` over ``n_dev`` devices: device r folds r into every step key
    and draws its n_mc / n_dev lanes and its minibatch from it."""
    keys = jax.random.split(key, n_steps)
    loc = cfg._replace(n_mc=cfg.n_mc // n_dev)
    return [_shf_step_draws(jax.vmap(lambda k: jax.random.fold_in(k, r))(keys), N, d, loc)
            for r in range(n_dev)]
