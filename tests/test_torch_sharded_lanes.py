"""The port's lane-sharded entry points on gloo process groups against the
JAX ones on the virtual CPU mesh of the same shape, under the JAX draws:
``parallel.make_sharded_bpsvi_batch`` (tests/test_parallel.py:189-205),
``inference.run_chains_sharded`` with HMC and with NUTS
(tests/test_inference.py:220-252, :377-390), ``inference.make_sharded_shf_trainer``
(tests/test_shf.py:108-120) and ``valuation.make_dshapley`` /
``make_tmc_shapley`` with ``mesh=`` (tests/test_valuation.py:74-85), each at
the JAX test's sizes, in float64.

For each mesh shape (1, 1), (2, 2) and (4, 1), one world of spawned
processes (tests/torch_dist_worker.py) runs every case. The JAX draws are
rebuilt from its keys: the BPSVI lanes' from ``split(key, L)``, the chains'
from ``split(key, C)`` (tests/torch_jax_mcmc.py; the padding lanes are
dropped), each device's flow lanes and minibatch from the step keys folded
with its index, the Shapley rounds from ``split(key, T + pad)[:T]``.
Every rank must return the same result, and each is also held against the
port's single-device counterpart under the same draws: BPSVI lane i is
``bpsvi_build_batch``'s lane i bit for bit, chain i is ``run_chains``'s (or
``run_chains_nuts``'s) chain i to 1e-12 (at the JAX tests' 150 + 150
iterations; against JAX over 12 + 12, where the two still agree to 1e-10),
the estimate is ``mesh=None``'s up
to float32 summation order (1e-6), and in a world of one the flow trainer
is ``make_shf_trainer`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.coresets import BPSVIConfig as JBPSVIConfig
from betacores_tpu.coresets.groups import group_ids_from_groups as jgids
from betacores_tpu.inference import hmc as jhmc
from betacores_tpu.inference import nuts as jnuts
from betacores_tpu.inference import shf as jshf
from betacores_tpu.inference.samplers import gaussian_conjugate_sampler as jg_sampler
from betacores_tpu.models import gaussian as jgauss
from betacores_tpu.ops.projection import Groups as JGroups
from betacores_tpu.parallel import make_mesh as jmake_mesh
from betacores_tpu.parallel import make_sharded_bpsvi_batch as jbpsvi_batch
from betacores_tpu.valuation import logreg_laplace_value_fn as j_value_fn
from betacores_tpu.valuation import make_dshapley as j_dshapley
from test_torch_bpsvi import jax_bpsvi_draws
from tests.torch_jax_mcmc import hmc_draws, nuts_draws, sharded_shf_draws
from torch_dist_worker import run_world

torch.set_num_threads(1)

RTOL = 1e-10                 # MCMC and SHF against JAX, float64

# BPSVI: tests/test_parallel.py:189-205 (the Gaussian problem's first 120 rows)
BP_CFG = dict(projection_dim=8, n_subsample_opt=32, opt_itrs=15, i0=0.3)
BP_SIZES, BP_MAX = list(range(1, 11)), 10
# chains: tests/test_inference.py:220-252 and :377-390 (the standard normal in d = 2),
# and the iterations of the runs held against JAX to RTOL: the port and JAX round a
# few ulp apart (exp, log), the warmup's adaptation carries that along, and at
# 150 + 150 iterations it has grown past 1e-7 (NUTS) or flipped an HMC accept; the
# JAX test itself holds its sharded chains to run_chains only statistically
HMC_CFG = dict(n_samples=150, n_warmup=150, L_max=16)
NUTS_CFG = dict(n_samples=150, n_warmup=150, max_treedepth=6)
CHAINS, PADDED, SHORT = 8, 5, 12
# SHF: tests/test_shf.py:108-120's Gaussian-mean problem and configuration
SHF_CFG = dict(n_blocks=4, n_leapfrog=5, n_mc=8, n_batch=128, learning_rate=1e-2)
SHF_STEPS = 20
# Shapley: tests/test_valuation.py:74-85
SHAP_T, SHAP_GROUPS, SHAP_SAMPLES = 16, 6, 128


def _gauss_problem():
    """tests/test_parallel.py's known-covariance Gaussian (Sig = 3 I),
    its first 120 rows, and the model spec of its conjugate sampler."""
    rng = np.random.default_rng(11)
    Sig = 3.0 * np.eye(4)
    X = rng.multivariate_normal(np.zeros(4), Sig, 600)[:120]
    spec = ("gaussian", np.zeros(4), np.eye(4), np.linalg.inv(Sig),
            float(np.linalg.slogdet(Sig)[1]))
    return X, spec


def _shf_problem():
    """tests/test_shf.py's Gaussian-mean data (d = 2, N = 400, Siginv = I)."""
    return np.random.default_rng(42).normal(size=(400, 2)) + 1.5


def _valuation_problem():
    """tests/test_valuation.py's: 6 groups of 25 rows, groups 4 and 5 with
    every label flipped, and 400 test rows (tests/test_torch_valuation.py)."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(150, 4))
    y = np.where(rng.uniform(size=150) < 1 / (1 + np.exp(-X @ np.ones(4))), 1.0, -1.0)
    groups = [list(range(g * 25, (g + 1) * 25)) for g in range(6)]
    for g in (4, 5):
        y[groups[g]] = -y[groups[g]]
    Xt = rng.normal(size=(400, 4))
    yt = np.where(rng.uniform(size=400) < 1 / (1 + np.exp(-Xt @ np.ones(4))), 1.0, -1.0)
    return (y[:, None] * X, Xt, yt), groups


def _shapley_rounds(key, T, n_keys, groups):
    """The draws of T rounds of the JAX estimator from the first T of
    ``split(key, n_keys)`` (tests/test_torch_valuation.py's recipe)."""
    out = []
    for k in jax.random.split(key, n_keys)[:T]:
        kp, _, kv = jax.random.split(k, 3)
        perm = np.array(jax.random.permutation(kp, len(groups)))
        noise = np.stack([np.array(jax.random.normal(jax.random.fold_in(kv, j),
                                                     (SHAP_SAMPLES, 4), dtype=jnp.float64))
                          for j in range(len(groups))])
        out.append((perm.astype(np.int64), None, noise))
    return out


def _numpy(draws):
    """An HMCDraws or NUTSDraws as (init, phases) of numpy arrays."""
    return draws.init.numpy(), [tuple(x.numpy() for x in ph) for ph in draws.phases]


def _cases(n_data, n_samp):
    """(jobs, JAX results) of every case on an (n_data, n_samp) mesh."""
    mesh = jmake_mesh(n_data, n_samp)
    n_dev = n_data * n_samp
    jobs, want = {}, {}

    X, spec = _gauss_problem()
    _, mu0, Sig0inv, Siginv, logdet = spec
    smp = jg_sampler(jnp.asarray(mu0), jnp.asarray(Sig0inv), jnp.asarray(Siginv))
    key = jax.random.key(7)
    w, p, i = jbpsvi_batch(jnp.asarray(X), jgauss.bundle(jnp.asarray(Siginv), logdet), smp,
                           JBPSVIConfig(**BP_CFG), mesh)(key, BP_SIZES, BP_MAX, jnp.zeros(4))
    want["bpsvi"] = tuple(np.asarray(x) for x in (w, p, i))
    noise = lambda k: smp.draw_noise(k, BP_CFG["projection_dim"], jnp.ones(1),
                                     jnp.zeros((1, 4)), None)
    draws = [jax_bpsvi_draws(k, BP_MAX, len(X), noise, BP_CFG["opt_itrs"],
                             BP_CFG["n_subsample_opt"])
             for k in jax.random.split(key, len(BP_SIZES))]
    jobs["bpsvi"] = dict(kind="bpsvi", data=X, model=spec, cfg=BP_CFG, sizes=BP_SIZES,
                         max_size=BP_MAX, aux0=np.zeros(4),
                         draws=[tuple(None if x is None else x.numpy() for x in d)
                                for d in draws])
    jobs["bpsvi_generator"] = dict(jobs["bpsvi"], generator_seed=3)

    std = lambda th: -0.5 * jnp.sum(th * th)
    for name, cfg, nuts in (("hmc", HMC_CFG, False), ("nuts", NUTS_CFG, True)):
        short = dict(cfg, n_samples=SHORT, n_warmup=SHORT)
        jcfg = (jnuts.NUTSConfig if nuts else jhmc.HMCConfig)(**short)
        s, st = jhmc.run_chains_sharded(jax.random.key(1), std, jnp.zeros(2), CHAINS, mesh,
                                        jcfg)
        want[name] = (np.asarray(s), {k: np.asarray(v) for k, v in st.items()})
        draw = nuts_draws if nuts else hmc_draws
        jobs[name] = dict(kind="chains", nuts=nuts, cfg=short, target=("std_normal",),
                          theta0=np.zeros(2), n_chains=CHAINS,
                          draws=_numpy(draw(jax.random.key(1), CHAINS, 2, jcfg)))
        long_cfg = (jnuts.NUTSConfig if nuts else jhmc.HMCConfig)(**cfg)
        jobs[name + "_long"] = dict(jobs[name], cfg=cfg,
                                    draws=_numpy(draw(jax.random.key(1), CHAINS, 2, long_cfg)))
        jobs[name + "_padded"] = dict(jobs[name + "_long"], n_chains=PADDED, generator_seed=4)

    Xs = _shf_problem()
    jcfg = jshf.SHFConfig(**SHF_CFG)
    params = jshf.init_shf_params(jnp.asarray(Xs[:20]), 2, len(Xs), jcfg)
    key = jax.random.key(1)
    jp, jtr = jshf.make_sharded_shf_trainer(jnp.asarray(Xs), jshf.gaussian_log_joint(
        jnp.eye(2)), mesh, jcfg)(key, params, SHF_STEPS)
    want["shf"] = ([np.asarray(x) for x in jp], np.asarray(jtr))
    jobs["shf"] = dict(kind="shf", data=Xs, Siginv=np.eye(2), cfg=SHF_CFG,
                       params=[np.asarray(x) for x in params], n_steps=SHF_STEPS,
                       draws=[tuple(x.numpy() for x in d) for d in
                              sharded_shf_draws(key, SHF_STEPS, len(Xs), 2, jcfg, n_dev)])
    jobs["shf_generator"] = dict(jobs["shf"], generator_seed=5)

    args, groups = _valuation_problem()
    gp = JGroups.from_lists(groups)
    jargs = tuple(jnp.asarray(a) for a in args)
    key = jax.random.key(3)
    phis = j_dshapley(jgids(gp, len(args[0])), gp, j_value_fn(n_samples=SHAP_SAMPLES),
                      max_groups=SHAP_GROUPS, mesh=mesh, value_args=jargs)(key, SHAP_T)
    want["dshapley"] = np.asarray(phis)
    n_keys = SHAP_T + (-SHAP_T) % n_dev
    jobs["dshapley"] = dict(kind="shapley", estimator="dshapley", groups=groups,
                            value_args=args, n_samples=SHAP_SAMPLES, max_groups=SHAP_GROUPS,
                            T=SHAP_T, draws=_shapley_rounds(key, SHAP_T, n_keys, groups))
    jobs["tmc"] = dict(jobs["dshapley"], estimator="tmc", full_value=0.9, tol=0.005,
                       T=SHAP_T - 3, draws=jobs["dshapley"]["draws"][:SHAP_T - 3])
    return jobs, want


@pytest.fixture(scope="module", params=[(1, 1), (2, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def lanes(request):
    """(jobs, JAX results, per-rank port results, mesh shape)."""
    jobs, want = _cases(*request.param)
    ranks = run_world(*request.param, jobs)
    return jobs, want, ranks, request.param


def _same_on_every_rank(ranks, name):
    """The result every rank returned for ``name``; they must be equal."""
    outs = [r["jobs"][name] for r in ranks]

    def same(a, b, where):
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            for k, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{k}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)

    for o in outs[1:]:
        same(o, outs[0], name)
    return outs[0]


def _close(got, want, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=rtol,
                               err_msg=what)


def _bpsvi_single(job, draws):
    from betacores_tpu_torch.coresets import (BPSVIConfig, BPSVIDraws, bpsvi_build_batch,
                                             make_bpsvi_builder)
    from torch_dist_worker import _model

    model, sampler = _model(job["model"])
    b = make_bpsvi_builder(torch.from_numpy(job["data"]), model, sampler,
                           BPSVIConfig(**job["cfg"]))
    if draws is None:
        draws = [BPSVIDraws(*(None if x is None else torch.from_numpy(x) for x in d))
                 for d in job["draws"]]
    return bpsvi_build_batch(b, draws, job["sizes"], job["max_size"],
                             torch.from_numpy(job["aux0"]))


def test_bpsvi_lanes_match_jax_and_the_single_device_batch(lanes):
    """Every lane against the JAX sharded batch's (rtol 1e-9, as
    tests/test_torch_bpsvi.py holds the batch), and bit for bit against
    ``bpsvi_build_batch`` under the same draws; one gather in all."""
    jobs, want, ranks, _ = lanes
    got = _same_on_every_rank(ranks, "bpsvi")
    jw, jp, ji = want["bpsvi"]
    _close(got["wts"], jw, 1e-9, "wts")
    _close(got["pts"], jp, 1e-9, "pts")
    np.testing.assert_array_equal(got["idcs"], ji)
    for g, s in zip((got["wts"], got["pts"], got["idcs"]), _bpsvi_single(jobs["bpsvi"], None)):
        np.testing.assert_array_equal(g, s.numpy())
    assert got["calls"] == {"all_gather": 1}


def test_bpsvi_generator_lanes_are_the_batch_lanes(lanes):
    """Every rank draws the whole batch's draws from a generator seeded
    alike: lane i is ``bpsvi_build_batch``'s lane i under that generator,
    bit for bit, the padding lanes drawn after the true ones."""
    jobs, _, ranks, _ = lanes
    got = _same_on_every_rank(ranks, "bpsvi_generator")
    single = _bpsvi_single(jobs["bpsvi"], torch.Generator().manual_seed(3))
    for g, s in zip((got["wts"], got["pts"], got["idcs"]), single):
        np.testing.assert_array_equal(g, s.numpy())


def _single_chains(job, generator=None):
    from betacores_tpu_torch.inference import (HMCConfig, HMCDraws, HMCPhaseDraws, NUTSConfig,
                                               NUTSDraws, NUTSPhaseDraws, run_chains,
                                               run_chains_nuts)

    nuts = job["nuts"]
    Phase, Draws = (NUTSPhaseDraws, NUTSDraws) if nuts else (HMCPhaseDraws, HMCDraws)
    key = generator
    if key is None:
        init, phases = job["draws"]
        key = Draws(torch.from_numpy(init),
                    tuple(Phase(*(torch.from_numpy(x) for x in ph)) for ph in phases))
    run = run_chains_nuts if nuts else run_chains
    cfg = (NUTSConfig if nuts else HMCConfig)(**job["cfg"])
    return run(key, lambda th: -0.5 * torch.sum(th * th, dim=-1),
               torch.zeros(2, dtype=torch.float64), job["n_chains"], cfg)


@pytest.mark.parametrize("name", ["hmc", "nuts"])
def test_chains_match_jax(lanes, name):
    """Each chain's draws and stats against the JAX sharded chains under
    their keys, SHORT + SHORT iterations (rtol 1e-10); one gather in all."""
    _, want, ranks, _ = lanes
    got = _same_on_every_rank(ranks, name)
    js, jst = want[name]
    assert got["samples"].shape == js.shape == (CHAINS, SHORT, 2)
    _close(got["samples"], js, RTOL, "samples")
    for k, v in jst.items():
        _close(got["stats"][k], v, RTOL, k)
    assert got["calls"] == {"all_gather": 1}


@pytest.mark.parametrize("name", ["hmc_long", "nuts_long"])
def test_chains_equal_run_chains_and_converge(lanes, name):
    """At the JAX tests' 150 + 150 iterations under the JAX chains' draws:
    each chain is the single-device runner's chain under the same draws
    (1e-12: a rank batches fewer chains, so its products may round in
    another order), and the chains pass the JAX tests' diagnostics
    (split-R-hat below 1.05; HMC's ESS above 200, NUTS without a
    divergence)."""
    from betacores_tpu_torch.inference import summarize_chains

    jobs, _, ranks, _ = lanes
    got = _same_on_every_rank(ranks, name)
    s, st = _single_chains(jobs[name])
    assert got["samples"].shape == (CHAINS, 150, 2)
    _close(got["samples"], s.numpy(), 1e-12, "samples")
    for k, v in st.items():
        _close(got["stats"][k], v.numpy(), 1e-12, k)
    summ = summarize_chains(torch.from_numpy(got["samples"]))
    assert (summ["rhat"].numpy() < 1.05).all()
    if name == "hmc_long":
        assert (summ["ess"].numpy() > 200).all()
    else:
        assert got["stats"]["n_divergent"].sum() == 0


@pytest.mark.parametrize("name", ["hmc_padded", "nuts_padded"])
def test_padded_chains_on_the_ports_generator(lanes, name):
    """5 chains over 4 ranks: padded to 8 and dropped; on a generator
    seeded alike each chain is ``run_chains``'s (``run_chains_nuts``'s)
    chain under that generator."""
    jobs, _, ranks, _ = lanes
    got = _same_on_every_rank(ranks, name)
    assert got["samples"].shape == (PADDED, 150, 2)
    s, st = _single_chains(jobs[name], torch.Generator().manual_seed(4))
    _close(got["samples"], s.numpy(), 1e-12, "samples")
    for k, v in st.items():
        assert got["stats"][k].shape[0] == PADDED
        _close(got["stats"][k], v.numpy(), 1e-12, k)


def test_shf_trainer_matches_jax(lanes):
    """Each device's flow lanes and minibatch under its JAX keys: the
    trained params and the ELBO trace against the JAX sharded trainer's
    (rtol 1e-10); two psums a step."""
    _, want, ranks, _ = lanes
    got = _same_on_every_rank(ranks, "shf")
    jp, jtr = want["shf"]
    _close(got["trace"], jtr, RTOL, "elbo trace")
    for name, g, w in zip(jshf.SHFParams._fields, got["params"], jp):
        _close(g, w, RTOL, name)
    assert got["calls"] == {"psum": 2 * SHF_STEPS}


def test_shf_generator_draws(lanes):
    """On a generator seeded alike every rank keeps its own lanes and
    minibatch (the ranks agree on the params); in a world of one the
    trainer is ``make_shf_trainer`` under that generator, bit for bit."""
    from betacores_tpu_torch.inference import (SHFConfig, SHFParams, gaussian_log_joint,
                                               make_shf_trainer)

    jobs, _, ranks, shape = lanes
    got = _same_on_every_rank(ranks, "shf_generator")
    assert np.isfinite(got["trace"]).all() and (got["params"][0] >= 0).all()
    if shape != (1, 1):
        return
    job = jobs["shf_generator"]
    train = make_shf_trainer(torch.from_numpy(job["data"]), gaussian_log_joint(torch.eye(
        2, dtype=torch.float64)), SHFConfig(**job["cfg"]))
    params, trace = train(torch.Generator().manual_seed(5),
                          SHFParams(*(torch.from_numpy(x) for x in job["params"])), SHF_STEPS)
    np.testing.assert_array_equal(got["trace"], trace.numpy())
    for g, w in zip(got["params"], params):
        np.testing.assert_array_equal(g, w.numpy())


def _shapley_single(job):
    from betacores_tpu_torch.coresets import group_ids_from_groups
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.valuation import (logreg_laplace_value_fn, make_dshapley,
                                               make_tmc_shapley)
    from betacores_tpu_torch.valuation.shapley import PermutationDraws

    gp = Groups.from_lists(job["groups"], "cpu")
    args = tuple(torch.from_numpy(a) for a in job["value_args"])
    gid = group_ids_from_groups(gp, args[0].shape[0])
    value_fn = logreg_laplace_value_fn(n_samples=job["n_samples"])
    if job["estimator"] == "dshapley":
        est = make_dshapley(gid, gp, value_fn, job["max_groups"], value_args=args)
    else:
        est = make_tmc_shapley(gid, gp, value_fn, job["full_value"], tol=job["tol"],
                               value_args=args)
    draws = [PermutationDraws(*(None if x is None else torch.from_numpy(x) for x in d))
             for d in job["draws"]]
    return est(draws, job["T"]).numpy()


def test_dshapley_over_the_mesh_matches_jax_and_mesh_none(lanes):
    """The rounds split over the ranks: the JAX sharded estimate under its
    rounds' draws and the port's ``mesh=None`` estimate under the same
    draws, each within 1e-6 (float32 sums in another order); one psum."""
    jobs, want, ranks, _ = lanes
    got = _same_on_every_rank(ranks, "dshapley")
    np.testing.assert_allclose(got["phis"], want["dshapley"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["phis"], _shapley_single(jobs["dshapley"]), rtol=0,
                               atol=1e-6)
    assert got["calls"] == {"psum": 1}


def test_tmc_over_the_mesh_matches_mesh_none(lanes):
    """Truncated Monte-Carlo Shapley over 13 rounds (padded to the ranks):
    the port's ``mesh=None`` estimate under the same draws, within 1e-6."""
    jobs, _, ranks, _ = lanes
    got = _same_on_every_rank(ranks, "tmc")
    np.testing.assert_allclose(got["phis"], _shapley_single(jobs["tmc"]), rtol=0, atol=1e-6)
    assert got["phis"][:4].mean() > got["phis"][4:].mean()
