"""Neural-linear model: a deep feature extractor under an exact Bayesian
last layer (counterpart of betacores_tpu/models/neural_linear.py).

  * ``Encoder``: 2 x (Linear -> BatchNorm -> ReLU), with the reference's
    (flax) semantics: Linear kernels drawn from LeCun's truncated normal
    with zero biases; BatchNorm normalising with the biased batch variance
    E[x^2] - E[x]^2 (clipped at 0), eps 1e-5, and keeping the running
    statistics as running = 0.9 running + 0.1 batch, the biased variance
    included (``torch.nn.BatchNorm1d`` keeps the unbiased one, so the
    statistics are updated here by hand). The forward is one function of
    a state mapping (``apply_encoder``), so a builder can run it on static
    buffers;
  * ``bayesian_regression_posterior`` and the Student-t
    ``full_bayesian_regression_posterior`` of the last layer (with the
    reference's explicit ``inv``, through which the training gradient
    flows), ``predictive`` and the two log densities;
  * ``NeuralLinear``: ``encode``, ``update_batch``, ``forward``,
    ``optimize`` (weighted predictive-NLL minibatch training) and
    ``test``. The reference's optimiser is optax's
    ``chain(add_decayed_weights(wd, mask), adam(cosine schedule))``: the
    decay is added to the gradient before Adam (coupled L2, not AdamW), so
    here it is ``torch.optim.Adam`` with ``weight_decay`` on the group of
    Linear and BatchNorm weights and 0 on the biases, its rate set before
    every step from the closed-form cosine schedule. A step runs the
    encoder in train mode twice, over the whole current coreset (which
    gives the posterior, and whose batch statistics are the only ones
    kept) and over the minibatch (normalised with its own statistics);
  * the context factories ``encoded_z_fn``, ``neural_linear_model_factory``
    and ``neural_linear_sampler_factory``: ``ctx -> ModelFns`` and
    ``ctx -> sampler`` over rows z = [x, y] seen as [encode(x), y], the
    encoder in eval mode. The sampler has a noise split, so the builders
    draw a pass's noise ahead (the reference's call sampler draws one step
    at a time). A contextual builder hands the factories its static
    context buffers, which are read at each call.

Weights carry across with ``encoder_state_from_flax`` and
``encoder_state_to_numpy``.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..inference.samplers import LinregConjugateSampler
from ..utils.device import resolve_device
from . import linreg
from .base import ModelFns

EPS = 1e-5                 # flax BatchNorm's epsilon
MOMENTUM = 0.9             # flax's: running = 0.9 running + 0.1 batch (torch's momentum=0.1)
N_LAYERS = 2
# flax's lecun_normal: a normal truncated to [-2, 2], scaled so that the
# truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """The parameters and running statistics of one BatchNorm layer; the
    normalisation itself is ``apply_encoder``'s."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))


class Encoder(nn.Module):
    """2 x (Linear -> BatchNorm -> ReLU) from ``in_features`` to
    ``out_features``. Its state (``state()``) maps ``dense{i}.weight`` /
    ``.bias``, ``norm{i}.weight`` / ``.bias`` / ``.running_mean`` /
    ``.running_var`` to tensors."""

    def __init__(self, in_features: int, out_features: int = 30):
        super().__init__()
        self.out_features = out_features
        self.dense0 = nn.Linear(in_features, out_features)
        self.norm0 = BatchNorm(out_features)
        self.dense1 = nn.Linear(out_features, out_features)
        self.norm1 = BatchNorm(out_features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation: LeCun truncated-normal kernels, zero
        biases, unit scales, running mean 0 and variance 1."""
        with torch.no_grad():
            for i in range(N_LAYERS):
                dense = getattr(self, f"dense{i}")
                std = math.sqrt(1.0 / dense.in_features) / _TRUNC_STD
                w = torch.empty(dense.weight.shape, dtype=dense.weight.dtype)
                nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                      generator=generator)
                dense.weight.copy_(w)
                dense.bias.zero_()
                norm = getattr(self, f"norm{i}")
                norm.weight.fill_(1.0)
                norm.bias.zero_()
                norm.running_mean.zero_()
                norm.running_var.fill_(1.0)

    def state(self) -> dict:
        """The live parameters and running statistics by name."""
        return {**dict(self.named_parameters()), **dict(self.named_buffers())}

    def forward(self, x, train: bool = False):
        return apply_encoder(self.state(), x, train)[0]


def apply_encoder(ctx: Mapping, x, train: bool = False):
    """(features, batch statistics) of the encoder with state ``ctx`` on
    rows ``x``. Eval mode normalises with the running statistics and
    returns no statistics; train mode normalises each layer with its batch
    mean and biased variance E[x^2] - E[x]^2 (clipped at 0) and returns
    them, [(mean, var)] * 2. Computes in the promotion of the rows' and the
    state's dtypes."""
    stats = []
    for i in range(N_LAYERS):
        W, b = ctx[f"dense{i}.weight"], ctx[f"dense{i}.bias"]
        dt = torch.promote_types(x.dtype, W.dtype)
        x = x.to(dt) @ W.to(dt).T + b.to(dt)
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            stats.append((mean, var))
        else:
            mean = ctx[f"norm{i}.running_mean"].to(dt)
            var = ctx[f"norm{i}.running_var"].to(dt)
        mul = torch.rsqrt(var + EPS) * ctx[f"norm{i}.weight"].to(dt)
        x = torch.relu((x - mean) * mul + ctx[f"norm{i}.bias"].to(dt))
    return x, stats


def update_running_stats(ctx: Mapping, stats: Sequence) -> None:
    """running = MOMENTUM running + (1 - MOMENTUM) batch, in place, for
    the batch statistics of one train-mode pass."""
    with torch.no_grad():
        for i, (mean, var) in enumerate(stats):
            for name, batch in (("running_mean", mean), ("running_var", var)):
                r = ctx[f"norm{i}.{name}"]
                r.copy_(MOMENTUM * r + (1.0 - MOMENTUM) * batch.to(r.dtype))


def encoder_state_from_flax(variables, device="cuda") -> dict:
    """The port's encoder state from the reference's ``NeuralLinear.variables``
    (flax ``params`` and ``batch_stats``, as NumPy arrays or anything
    ``np.asarray`` takes): a Dense kernel (in, out) becomes the Linear
    weight (out, in), a BatchNorm scale / bias its weight / bias, its
    mean / var the running mean / variance. Dtypes are kept."""
    params, stats = variables["params"], variables["batch_stats"]
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    out = {}
    for i in range(N_LAYERS):
        out[f"dense{i}.weight"] = t(np.asarray(params[f"Dense_{i}"]["kernel"]).T)
        out[f"dense{i}.bias"] = t(params[f"Dense_{i}"]["bias"])
        out[f"norm{i}.weight"] = t(params[f"BatchNorm_{i}"]["scale"])
        out[f"norm{i}.bias"] = t(params[f"BatchNorm_{i}"]["bias"])
        out[f"norm{i}.running_mean"] = t(stats[f"BatchNorm_{i}"]["mean"])
        out[f"norm{i}.running_var"] = t(stats[f"BatchNorm_{i}"]["var"])
    return out


def encoder_state_to_numpy(state: Mapping) -> dict:
    """The inverse of ``encoder_state_from_flax``: flax's nested
    ``{"params": ..., "batch_stats": ...}`` of NumPy arrays."""
    a = lambda k: state[k].detach().cpu().numpy()
    params, stats = {}, {}
    for i in range(N_LAYERS):
        params[f"Dense_{i}"] = {"kernel": a(f"dense{i}.weight").T.copy(),
                                "bias": a(f"dense{i}.bias")}
        params[f"BatchNorm_{i}"] = {"scale": a(f"norm{i}.weight"), "bias": a(f"norm{i}.bias")}
        stats[f"BatchNorm_{i}"] = {"mean": a(f"norm{i}.running_mean"),
                                   "var": a(f"norm{i}.running_var")}
    return {"params": params, "batch_stats": stats}


class BayesLastLayer(NamedTuple):
    """The last layer's exact posterior over its weights and, for the
    Student-t variant, the noise posterior."""

    theta_mean: torch.Tensor              # (F, 1)
    theta_cov: torch.Tensor               # (F, F)
    a_tilde: Optional[torch.Tensor] = None
    b_tilde: Optional[torch.Tensor] = None

    @property
    def nu(self):
        return None if self.a_tilde is None else 2.0 * self.a_tilde


def _eye(F: int, X) -> torch.Tensor:
    return torch.eye(F, dtype=X.dtype, device=X.device)


def bayesian_regression_posterior(X, y, sigsq: float = 1.0, s: float = 1.0) -> BayesLastLayer:
    """theta_cov = sigsq (X^T X + sigsq s I)^-1, theta_mean =
    theta_cov / sigsq X^T y."""
    prec = X.T @ X + sigsq * s * _eye(X.shape[1], X)
    cov = sigsq * torch.linalg.inv(prec)
    mean = cov / sigsq @ (X.T @ y)
    return BayesLastLayer(theta_mean=mean, theta_cov=cov)


def full_bayesian_regression_posterior(X, y, a0: float = 1.0, b0: float = 1.0,
                                       s: float = 1.0) -> BayesLastLayer:
    """The Student-t variant, with an inverse-gamma prior (a0, b0) on the
    noise variance."""
    prec = X.T @ X + s * _eye(X.shape[1], X)
    cov = torch.linalg.inv(prec)
    mean = cov @ (X.T @ y)
    a_t = torch.full((), a0 + X.shape[0] / 2.0, dtype=X.dtype, device=X.device)
    b_t = b0 + 0.5 * (y.T @ y - mean.T @ prec @ mean).reshape(())
    return BayesLastLayer(theta_mean=mean, theta_cov=cov, a_tilde=a_t, b_tilde=b_t)


def predictive(layer: BayesLastLayer, x, sigsq: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive mean and variance, each (n, 1), at encoded inputs x."""
    mean = x @ layer.theta_mean
    quad = torch.sum((x @ layer.theta_cov) * x, dim=-1)
    if layer.a_tilde is None:
        var = sigsq + quad
    else:
        var = layer.b_tilde / layer.a_tilde * (1.0 + quad)
    return mean, var[:, None]


def gaussian_log_density(y, mean, var):
    return -0.5 * ((y - mean) ** 2 / var + torch.log(var) + math.log(2 * math.pi))


def students_t_log_density(y, mean, var, nu):
    std = torch.sqrt(var)
    z = (y - mean) / std
    nu_t = (nu + 1.0) / 2.0
    return (torch.lgamma(nu_t) - torch.log(torch.sqrt(nu * math.pi) * std)
            - torch.lgamma(nu / 2.0) - nu_t * torch.log1p(z * z / nu))


def batch_size_pow2(n: int) -> int:
    """The largest power of two below n/2 (n/2 itself when n is a power of
    two up to 512), as the reference picks its minibatch."""
    sizes = 2 ** np.arange(10)
    if n in sizes:
        return max(int(n // 2), 1)
    return int(sizes[max(int(np.sum((n / 2) > sizes)) - 1, 0)])


def cosine_decay_lr(initial_lr: float, decay_steps: int, t: int, alpha: float) -> float:
    """optax's ``cosine_decay_schedule(initial_lr, decay_steps, alpha)`` at
    step count t (from 0), in float64."""
    c = min(t, decay_steps)
    return initial_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
                         + alpha)


def decay_mask(encoder: Encoder) -> dict:
    """Whether each parameter is weight-decayed: the Linear and BatchNorm
    weights are, the biases are not."""
    return {name: name.endswith(".weight") for name, _ in encoder.named_parameters()}


class NeuralLinear:
    """The reference's neural-linear wrapper: an ``Encoder`` on ``device``
    (None: the card; without CUDA that raises, so a CPU caller passes
    ``device="cpu"``) under an exact Bayesian last layer conditioned on the
    current coreset ``Z`` = [x, y] (``update_batch``). ``variables`` is the
    encoder's state (copies), the context of the contextual builders;
    assigning it loads a state. ``student_t=True`` is the Student-t
    variant. The encoder is initialised from ``seed``, and ``optimize``
    draws its minibatch orders from a generator seeded ``seed + 1``."""

    def __init__(self, Z_init, out_features: int = 30, output_mean: float = 0.0,
                 output_std: float = 1.0, sigmasq: float = 1.0, s: float = 1.0,
                 student_t: bool = False, seed: int = 42, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.out_features = out_features
        self.sigmasq = float(sigmasq)
        self.s = float(s)
        self.student_t = student_t
        self.output_mean = float(np.asarray(output_mean).reshape(-1)[0])
        self.output_std = float(np.asarray(output_std).reshape(-1)[0])
        self.update_batch(Z_init)
        self.module = Encoder(self.x_train.shape[1], out_features).to(dtype)
        self.module.reset_parameters(torch.Generator().manual_seed(seed))
        self.module.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    @property
    def variables(self) -> dict:
        return {k: v.detach().clone() for k, v in self.module.state().items()}

    @variables.setter
    def variables(self, state: Mapping) -> None:
        with torch.no_grad():
            for k, v in self.module.state().items():
                v.copy_(torch.as_tensor(state[k]))

    def _rows(self, Z) -> torch.Tensor:
        return torch.as_tensor(Z, dtype=self.dtype, device=self.device)

    # --- reference API ---
    def encode(self, x, variables=None):
        ctx = self.module.state() if variables is None else variables
        with torch.no_grad():
            return apply_encoder(ctx, self._rows(x))[0]

    def update_batch(self, Z) -> None:
        Z = self._rows(Z)
        self.x_train, self.y_train = Z[:, :-1], Z[:, -1:]

    def _posterior(self, feats):
        if self.student_t:
            return full_bayesian_regression_posterior(feats, self.y_train, s=self.s)
        return bayesian_regression_posterior(feats, self.y_train, sigsq=self.sigmasq, s=self.s)

    def forward(self, x):
        """Predictive mean and variance at raw inputs x."""
        with torch.no_grad():
            layer = self._posterior(self.encode(self.x_train))
            return predictive(layer, self.encode(x), sigsq=self.sigmasq)

    def _loss(self, w, z):
        """The weighted negative predictive log-likelihood of minibatch z
        under the posterior conditioned on the whole current coreset, and
        that pass's batch statistics."""
        ctx = self.module.state()
        feats_tr, stats = apply_encoder(ctx, self.x_train, train=True)
        feats_b, _ = apply_encoder(ctx, z[:, :-1], train=True)
        y = z[:, -1:]
        layer = self._posterior(feats_tr)
        mean, var = predictive(layer, feats_b, self.sigmasq)
        if self.student_t:
            ll = students_t_log_density(y, mean, var, layer.nu)
        else:
            ll = gaussian_log_density(y, mean, var)
        return -torch.sum(w[:, None] * ll), stats

    def optimize(self, wts, pts, num_epochs: int = 1000, initial_lr: float = 1e-2,
                 weight_decay: float = 1e-1, batch_size: Optional[int] = None,
                 perms=None) -> np.ndarray:
        """Weighted-NLL training of the encoder on the coreset (wts, pts):
        ``num_epochs`` epochs of n // batch_size minibatches each, in the
        order of one permutation per epoch, drawn from this object's
        generator or given as ``perms`` (num_epochs, n). Returns each
        epoch's mean minibatch loss."""
        w_all, z_all = self._rows(wts), self._rows(pts)
        n = z_all.shape[0]
        if batch_size is None:
            batch_size = batch_size_pow2(n)
        n_batches = max(n // batch_size, 1)
        decay_steps = num_epochs * n_batches
        alpha = 1e-5 / initial_lr
        mask = decay_mask(self.module)
        named = dict(self.module.named_parameters())
        opt = torch.optim.Adam(
            [{"params": [p for k, p in named.items() if mask[k]], "weight_decay": weight_decay},
             {"params": [p for k, p in named.items() if not mask[k]], "weight_decay": 0.0}],
            lr=initial_lr, betas=(0.9, 0.999), eps=1e-8)
        losses = torch.zeros(num_epochs, dtype=torch.float64, device=self.device)
        t = 0
        for e in range(num_epochs):
            perm = (torch.randperm(n, generator=self.generator, device=self.device)
                    if perms is None else torch.as_tensor(perms[e]).to(self.device))
            for b in range(n_batches):
                idx = perm[b * batch_size:(b + 1) * batch_size]
                lr = cosine_decay_lr(initial_lr, decay_steps, t, alpha)
                for group in opt.param_groups:
                    group["lr"] = lr
                opt.zero_grad(set_to_none=True)
                loss, stats = self._loss(w_all[idx], z_all[idx])
                loss.backward()
                opt.step()
                update_running_stats(self.module.state(), stats)
                losses[e] += loss.detach() / n_batches
                t += 1
        return losses.cpu().numpy()

    def test(self, Z_test) -> Tuple[float, float]:
        """(predictive NLL, RMSE in the unstandardised output units)."""
        Z = self._rows(Z_test)
        x, y = Z[:, :-1], Z[:, -1:]
        mean, var = self.forward(x)
        with torch.no_grad():
            if self.student_t:
                layer = self._posterior(self.encode(self.x_train))
                nll = -torch.mean(students_t_log_density(y, mean, var, layer.nu))
            else:
                nll = -torch.mean(gaussian_log_density(y, mean, var))
            unnorm = lambda v: v * self.output_std + self.output_mean
            rmse = torch.sqrt(torch.mean((unnorm(mean) - unnorm(y)) ** 2))
        return float(nll), float(rmse)


# --- context factories for the coreset builders -----------------------------


def encoded_z_fn(module: Encoder):
    """(ctx, z) -> [encode(x), y] with the encoder in eval mode (the
    running statistics) under state ``ctx``."""
    del module                      # the state carries the whole encoder

    def enc(ctx, z):
        feats = apply_encoder(ctx, z[:, :-1])[0]
        return torch.cat([feats, z[:, -1:].to(feats.dtype)], dim=1)

    return enc


def neural_linear_model_factory(module: Encoder, sigsq: float):
    """ctx -> ModelFns of linear regression over encoded rows."""
    enc = encoded_z_fn(module)

    def factory(ctx) -> ModelFns:
        return ModelFns(
            log_likelihood=lambda pts, th: linreg.log_likelihood(enc(ctx, pts), th, sigsq),
            beta_likelihood=lambda pts, th, beta: linreg.beta_likelihood(enc(ctx, pts), th,
                                                                         beta, sigsq),
            beta_gradient=lambda pts, th, beta: linreg.beta_gradient(enc(ctx, pts), th, beta,
                                                                     sigsq))

    return factory


class NeuralLinearSampler(LinregConjugateSampler):
    """The conjugate weighted posterior of the last layer over the encoded
    coreset rows, under state ``ctx``, split as the other conjugate
    samplers: ``draw_noise`` (n, F) standard normals in the dtype the
    posterior computes in, ``from_noise`` the posterior's
    ``sample_gaussian_prec_from_noise``."""

    def __init__(self, enc, ctx, mu0, Sig0inv, sigsq):
        super().__init__(mu0, Sig0inv, sigsq)
        self.enc, self.ctx = enc, ctx

    def _dtype(self, wts, pts) -> torch.dtype:
        enc_dt = torch.promote_types(pts.dtype, self.ctx["dense0.weight"].dtype)
        return torch.promote_types(self.prior.dtype, torch.promote_types(wts.dtype, enc_dt))

    def posterior(self, wts, pts):
        return super().posterior(wts, self.enc(self.ctx, pts))


def neural_linear_sampler_factory(module: Encoder, mu0, Sig0inv, sigsq: float):
    """ctx -> the conjugate sampler of the last layer over encoded rows."""
    enc = encoded_z_fn(module)
    return lambda ctx: NeuralLinearSampler(enc, ctx, mu0, Sig0inv, sigsq)
