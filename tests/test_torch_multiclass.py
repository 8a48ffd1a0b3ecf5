"""The port's multiclass (softmax) family against the JAX package's, in
float32 on the same seeded inputs: the model functions
(betacores_tpu_torch/models/multiclass.py), the plain version of the K2
projection kernel (ops/kernels.py::multiclass_projection_plain) against the
Pallas kernel in interpret mode, the projection engine's routing to the
fused field, and the Laplace sampler. The CUDA kernel itself is held
against the plain version on the card (test_torch_kernels_cuda.py).

Tolerances are float32's: both sides evaluate the same closed forms with
sums in another order. The kernel's is the JAX package's own for the
Pallas kernel against its composition (atol 2e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from betacores_tpu.inference.samplers import multiclass_laplace_sampler as jsampler
from betacores_tpu.models import multiclass as jmc
from betacores_tpu.ops.pallas_kernels import multiclass_projection_fused
from betacores_tpu.ops.projection import center as jcenter
from betacores_tpu_torch.inference import multiclass_laplace_sampler
from betacores_tpu_torch.models import multiclass
from betacores_tpu_torch.ops import kernels
from betacores_tpu_torch.ops.projection import project_beta, project_ll

torch.set_num_threads(1)
K, D_X = 4, 6


def rows(rng, n, d=D_X, k=K):
    """(n, d+1) float32 rows [x, y] with y a float class index."""
    return np.c_[rng.normal(size=(n, d)), rng.integers(0, k, n)].astype(np.float32)


@pytest.fixture
def inputs():
    rng = np.random.default_rng(5)
    Z = rows(rng, 40)
    TH = rng.normal(size=(9, K * D_X)).astype(np.float32)
    w = (3 * rng.uniform(size=40)).astype(np.float32)
    w[-6:] = 0.0                     # zero-weight padded rows
    return Z, TH, w


def _both(fn_j, fn_t, *args):
    got = fn_t(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    want = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return got, np.asarray(want)


def _close(got, want, rtol=2e-5):
    assert got.shape == want.shape and got.dtype == np.float32
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_log_likelihood(inputs):
    Z, TH, _ = inputs
    _close(*_both(jmc.make_log_likelihood(K), multiclass.make_log_likelihood(K), Z, TH))


@pytest.mark.parametrize("beta", [0.1, 0.5])
def test_beta_likelihood(inputs, beta):
    Z, TH, _ = inputs
    got, want = _both(jmc.make_beta_likelihood(K), multiclass.make_beta_likelihood(K),
                      Z, TH, np.float32(beta))
    _close(got, want)


def test_log_prior_and_log_joint(inputs):
    Z, TH, w = inputs
    _close(*_both(jmc.log_prior, multiclass.log_prior, TH[0]))
    _close(*_both(jmc.make_log_joint(K), multiclass.make_log_joint(K), Z, TH[0], w))


def test_log_joint_takes_a_batch_of_candidates(inputs):
    """The port's Newton line search evaluates its candidates in one call:
    (C, K*d) -> (C,) equals the JAX log joint mapped over the candidates
    and the port's own single-theta calls."""
    Z, TH, w = inputs
    got = multiclass.make_log_joint(K)(torch.from_numpy(Z), torch.from_numpy(TH),
                                       torch.from_numpy(w)).numpy()
    jlj = jmc.make_log_joint(K)
    want = np.stack([np.asarray(jlj(jnp.asarray(Z), jnp.asarray(t), jnp.asarray(w)))
                     for t in TH])
    _close(got, want)
    one = multiclass.make_log_joint(K)
    single = np.stack([one(torch.from_numpy(Z), torch.from_numpy(t),
                           torch.from_numpy(w)).numpy() for t in TH])
    _close(got, single)


def test_grad_and_hess_of_the_log_joint(inputs):
    Z, TH, w = inputs
    _close(*_both(jmc.make_grad_th_log_joint(K), multiclass.make_grad_th_log_joint(K),
                  Z, TH[1], w))
    got, want = _both(jmc.make_hess_th_log_joint(K), multiclass.make_hess_th_log_joint(K),
                      Z, TH[1], w)
    assert got.shape == (K * D_X, K * D_X)
    _close(got, want)


def test_prediction(inputs):
    Z, TH, _ = inputs
    X, y = Z[:, :-1], Z[:, -1]
    _close(*_both(lambda x, t: jmc.predictive_probs(x, t, K),
                  lambda x, t: multiclass.predictive_probs(x, t, K), X, TH))
    acc_t = float(multiclass.compute_accuracy(torch.from_numpy(X), torch.from_numpy(y),
                                              torch.from_numpy(TH), K))
    acc_j = float(jmc.compute_accuracy(jnp.asarray(X), jnp.asarray(y), jnp.asarray(TH), K))
    assert acc_t == acc_j
    _close(*_both(lambda z, t: jmc.predictive_loglik(z, t, K),
                  lambda z, t: multiclass.predictive_loglik(z, t, K), Z, TH))


@pytest.mark.parametrize("beta", [None, 0.1, 0.5])
def test_plain_projection_matches_pallas_kernel(rng, beta):
    """K2's plain version, and the wrapper on CPU tensors, against the
    Pallas kernel (interpret mode) at unaligned rows and columns; the
    wrapper launches nothing on the CPU."""
    n_classes, d, N, S = 4, 6, 700, 50
    Z = rows(rng, N, d, n_classes)
    TH = rng.normal(size=(S, n_classes * d)).astype(np.float32)
    use_beta = beta is not None
    b = 1.0 if beta is None else beta
    want = np.asarray(multiclass_projection_fused(jnp.asarray(Z), jnp.asarray(TH),
                                                  n_classes, beta=b, use_beta=use_beta))
    before = kernels.multiclass_projection.launches
    for fn in (kernels.multiclass_projection_plain, kernels.multiclass_projection):
        got = fn(torch.from_numpy(Z), torch.from_numpy(TH), n_classes,
                 torch.tensor(b), use_beta)
        assert got.shape == (N, S) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert kernels.multiclass_projection.launches == before
    # and against the JAX composition it stands for
    ref = (jmc.make_beta_likelihood(n_classes)(jnp.asarray(Z), jnp.asarray(TH), b)
           if use_beta else jmc.make_log_likelihood(n_classes)(jnp.asarray(Z), jnp.asarray(TH)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcenter(ref)), atol=2e-5)


def test_projection_routes_large_blocks_to_the_fused_field(rng):
    """ops/projection.py gives a block of at least FUSED_MIN_ROWS rows to
    the model's fused field, and a smaller one to the plain composition, as
    betacores_tpu/ops/projection.py does."""
    n_classes, d, S = 3, 4, 8
    assert kernels.FUSED_MIN_ROWS == 8192
    Z = torch.from_numpy(rows(rng, kernels.FUSED_MIN_ROWS, d, n_classes))
    TH = torch.from_numpy(rng.normal(size=(S, n_classes * d)).astype(np.float32))
    calls = []

    def stub_ll(pts, th):
        calls.append(("ll", pts.shape[0]))
        return kernels.multiclass_projection_plain(pts, th, n_classes)

    def stub_beta(pts, th, beta):
        calls.append(("beta", pts.shape[0]))
        return kernels.multiclass_projection_plain(pts, th, n_classes, beta, True)

    model = multiclass.bundle(n_classes)._replace(fused_ll_projection=stub_ll,
                                                  fused_beta_projection=stub_beta)
    plain = multiclass.bundle(n_classes, fused=False)
    assert plain.fused_ll_projection is None and plain.fused_beta_projection is None
    for n in (kernels.FUSED_MIN_ROWS - 1, kernels.FUSED_MIN_ROWS):
        for proj, args in ((project_ll, ()), (project_beta, (0.3,))):
            got = proj(model, Z[:n], TH, *args)
            assert torch.equal(got, proj(plain, Z[:n], TH, *args))
    assert calls == [("ll", 8192), ("beta", 8192)]
    # the bundle's own fused field is the K2 wrapper: on the CPU its plain
    # version, the same values as the composition
    fused = multiclass.bundle(n_classes)
    assert torch.equal(project_beta(fused, Z, TH, 0.3), project_beta(plain, Z, TH, 0.3))


def test_bundle_needs_two_classes():
    with pytest.raises(ValueError):
        multiclass.bundle(1)


@pytest.fixture
def coreset():
    """Coreset-like inputs: 20 live rows, 12 zero-weight padded rows, K=3,
    d=4, in float32."""
    rng = np.random.default_rng(11)
    k, d = 3, 4
    Th = 2.0 * rng.normal(size=(k, d))
    X = rng.normal(size=(32, d))
    y = np.argmax(X @ Th.T + rng.gumbel(size=(32, k)), axis=1)
    Z = np.c_[X, y].astype(np.float32)
    w = rng.uniform(0.5, 4.0, size=32).astype(np.float32)
    w[20:] = 0.0
    return Z, w, k, d


@pytest.mark.parametrize("warm", [False, True])
def test_sampler_fit_and_from_noise_match_jax(coreset, warm):
    """Cold and warm-started fits: mode and Cholesky factor of the
    reference's, and the same samples from the same noise. The port runs
    the Newton loop to its fixed count and freezes it where the JAX while
    loop stops; float32 round-off of the iterates bounds the difference."""
    Z, w, k, d = coreset
    jsmp, tsmp = jsampler(k), multiclass_laplace_sampler(k)
    assert getattr(tsmp, "fit_inv", None) is None
    aux = np.zeros(k * d, np.float32)
    if warm:
        aux = np.array(jsmp.fit(jnp.asarray(w), jnp.asarray(Z), jnp.asarray(aux)).mu)
        w = w * 1.3
    want = jsmp.fit(jnp.asarray(w), jnp.asarray(Z), jnp.asarray(aux))
    got = tsmp.fit(torch.from_numpy(w), torch.from_numpy(Z), torch.from_numpy(aux))
    assert got.mu.dtype == torch.float32
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.prec_chol.numpy(), np.asarray(want.prec_chol),
                               rtol=1e-4, atol=1e-4)
    z = np.random.default_rng(2).normal(size=(16, k * d)).astype(np.float32)
    ths_j, mu_j = jsmp.from_noise(jnp.asarray(z), jnp.asarray(w), jnp.asarray(Z),
                                  jnp.asarray(aux))
    ths_t, mu_t = tsmp.from_noise(torch.from_numpy(z), torch.from_numpy(w),
                                  torch.from_numpy(Z), torch.from_numpy(aux))
    assert ths_t.shape == (16, k * d)
    np.testing.assert_allclose(ths_t.numpy(), np.asarray(ths_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-4, atol=1e-4)
    # the sampler is draw_noise then from_noise, on the generator's stream
    gen = torch.Generator().manual_seed(0)
    a, _ = tsmp(gen, 16, torch.from_numpy(w), torch.from_numpy(Z), torch.from_numpy(aux))
    zz = tsmp.draw_noise(torch.Generator().manual_seed(0), 16, torch.from_numpy(w),
                         torch.from_numpy(Z), torch.from_numpy(aux))
    b, _ = tsmp.from_noise(zz, torch.from_numpy(w), torch.from_numpy(Z),
                           torch.from_numpy(aux))
    assert torch.equal(a, b)


def test_kernel_wrapper_has_no_route_off_cpu_or_cuda(rng):
    """A tensor on neither the CPU nor a card raises: there is no fallback."""
    Z = torch.from_numpy(rows(rng, 16))
    TH = torch.from_numpy(rng.normal(size=(5, K * D_X)).astype(np.float32))
    with pytest.raises(ValueError):
        kernels.multiclass_projection(Z.to("meta"), TH.to("meta"), K)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "classes", "features"])
def test_kernel_operand_checks_raise(rng, bad):
    """What the kernel does not take raises before a launch."""
    n_classes = kernels.MC_MAX_CLASSES + 1 if bad == "classes" else K
    d = kernels.MC_MAX_FEATURES + 1 if bad == "features" else D_X
    Z = torch.from_numpy(rows(rng, 16, d, n_classes))
    TH = torch.from_numpy(rng.normal(size=(5, n_classes * d)).astype(np.float32))
    if bad in ("dtype", "shape", "contiguous"):
        kernels._check_mc_operands(Z, TH, n_classes)         # the valid operands pass
    if bad == "dtype":
        TH = TH.double()
    elif bad == "shape":
        TH = TH[:, :-1]
    elif bad == "contiguous":
        Z = torch.from_numpy(rows(rng, 16, d + 1))[:, 1:]
    with pytest.raises((TypeError, ValueError)):
        kernels._check_mc_operands(Z, TH, n_classes)


@pytest.mark.parametrize("use_beta", [False, True])
def test_fused_projection_closures_keep_the_rows_dtype(use_beta):
    """The bundle's fused projections compute in float32 and return in the
    rows' dtype, as the reference's fused projection does: float64 rows and
    samples give the float32 result cast up, float32 ones are unchanged."""
    rng = np.random.default_rng(3)
    K_, d_, n_, s_ = 4, 3, 50, 7
    z = np.c_[rng.normal(size=(n_, d_)), rng.integers(0, K_, n_)]
    th = rng.normal(size=(s_, K_ * d_))
    b = multiclass.bundle(K_)
    call = ((lambda p, t: b.fused_beta_projection(p, t, torch.tensor(0.3, dtype=p.dtype)))
            if use_beta else b.fused_ll_projection)
    z64, th64 = torch.from_numpy(z), torch.from_numpy(th)
    got64 = call(z64, th64)
    got32 = call(z64.float(), th64.float())
    assert got64.dtype == torch.float64 and got32.dtype == torch.float32
    assert got64.shape == (n_, s_)
    assert torch.equal(got64, got32.double())
    # mixed: float64 rows with float32 samples still come back as the rows'
    assert call(z64, th64.float()).dtype == torch.float64


def test_grad_z_log_likelihood_and_beta_gradient_in_float64():
    """The data gradient (the label coordinate 0) and the bundle's
    d/d(beta) (torch.func.jvp of the plain beta-likelihood) against the
    JAX bundle's (jax.jvp), in float64 within rtol 1e-10."""
    rng = np.random.default_rng(8)
    Z = np.c_[rng.normal(size=(30, D_X)), rng.integers(0, K, 30)]
    TH = rng.normal(size=(7, K * D_X))
    got, want = _both(jmc.make_grad_z_log_likelihood(K),
                      multiclass.make_grad_z_log_likelihood(K), Z, TH)
    assert got.shape == (30, 7, D_X + 1) and (got[:, :, -1] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    for beta in (0.1, 0.7):
        got = multiclass.bundle(K).beta_gradient(torch.from_numpy(Z), torch.from_numpy(TH),
                                                 torch.tensor(beta, dtype=torch.float64))
        want = jmc.bundle(K).beta_gradient(jnp.asarray(Z), jnp.asarray(TH), beta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-14)
