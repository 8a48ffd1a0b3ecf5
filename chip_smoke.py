"""Smoke test of the PyTorch/CUDA port (betacores_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--selections 5]

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit. Phases, each of which raises on failure:

  0. device: requires CUDA; prints the card's name and power limit; turns
     TF32 off for float32 products;
  1. build: compiles the hand-written kernels (betacores_tpu_torch/csrc/)
     with nvcc for sm_90a;
  2. kernel against its plain twin on the card, at the main path's shapes
     and at one ragged shape, with and without the beta-likelihood, within
     atol = rtol = 2e-4; times both with CUDA events;
  3. the main path: the beta-Cores incremental build of bench.py
     (N = 1M contaminated logistic-regression rows, d = 10, S = 100,
     1000-row select subsample, 500 Adam steps on 200 rows per selection,
     128-slot buffer, beta = 0.1) for --selections selections, with every
     Adam step launched through the kernel;
  4. the slice against itself: a small build through the kernel equals the
     same build through the plain twin on the CPU under replayed draws, in
     reference-parity select and in dedup select with lagged refits.

The last two lines of standard output are a JSON object describing the
kernels, then {"ok": true, "device": {...}}. Without a card the script
exits nonzero and prints neither.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

TOL = 2e-4                      # kernel vs twin, float32 (the reference's own)
# the headline configuration of bench.py
N_ROWS, N_FEAT, S, BETA = 1_000_000, 10, 100, 0.1
N_SEL, N_OPT, OPT_ITRS, M_BUF = 1000, 200, 500, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                         "False); this smoke test runs only on a card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)                                          # name, power limit
    log("tf32: off for matmul and cudnn (float32 products in full float32)")
    return name


def phase_build() -> None:
    from betacores_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    path = _build.library_path("logreg_adam_step")
    kernels._lib()
    log(f"build: {path.name} in {time.perf_counter() - t0:.2f} s")
    report = path.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


def step_operands(gen, dev, n_sub, M_buf, n_live, d, S_true, packed: bool):
    """Random operands of one fused step. ``packed`` lays them out as the
    main path does (ops/kernels.py packers: subsample to 8 rows, buffer to
    128 slots, noise to 128 rows); otherwise nothing is padded."""
    from betacores_tpu_torch.ops import kernels

    f32 = dict(dtype=torch.float32, device=dev)
    rows = torch.randn((1, n_sub, d), generator=gen, **f32)
    pts = torch.randn((M_buf, d), generator=gen, **f32)
    live = torch.arange(M_buf, device=dev) < n_live
    z = torch.randn((1, S_true, d), generator=gen, **f32)
    if packed:
        xin, M_pad, _ = kernels.pack_fused_step_rows(rows, pts, live, n_sub)
        xin, z = xin[0], kernels.pad_fused_step_noise(z, S_true)[0]
    else:
        M_pad = M_buf
        xin = torch.cat([torch.cat([rows[0], torch.ones((n_sub, 1), **f32)], 1),
                         torch.cat([pts, live[:, None].to(torch.float32)], 1)])
        z = z[0]
    lower = torch.tril(torch.randn((d, d), generator=gen, **f32)) + 2 * torch.eye(d, **f32)
    linv = torch.linalg.inv(lower).contiguous()
    mu = torch.randn((1, d), generator=gen, **f32)
    w, m1, m2 = (torch.zeros((1, M_pad), **f32) for _ in range(3))
    w[0, :n_live] = 3 * torch.rand(n_live, generator=gen, **f32)
    m1[0, :n_live] = 0.1 * torch.randn(n_live, generator=gen, **f32)
    m2[0, :n_live] = 0.01 * torch.rand(n_live, generator=gen, **f32)
    sc = torch.tensor([BETA, N_ROWS / n_sub], **f32)
    sclr = kernels.adam_sclr_stack(torch.tensor([0.37, 0.2, 0.1], **f32))[2].contiguous()
    return (xin, z, mu, linv, w, m1, m2, sc, sclr), S_true


def _time_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _compare(got, want, exact, n_live: int, where: str) -> float:
    """Holds the kernel's (w', m1', m2') against the plain twin's. w' within
    atol = rtol = 2e-4. The Adam moments grow with the squared residual,
    ~(N / n)^2, and entries near a cancellation carry float32 error far
    above 2e-4 of their own size in any summation order, so m1' and m2' are
    held within 2e-4 of their largest magnitude. ``exact`` is the twin in
    float64, printed for scale. Padded slots must be exactly 0. Returns
    max |w'_kernel - w'_twin|."""
    for name, g, w, e in zip(("w", "m1", "m2"), got, want, exact):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        ok = (torch.allclose(g, w, atol=TOL, rtol=TOL) if name == "w"
              else err <= TOL * max(1.0, scale))
        log(f"  {where} {name}': max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}); "
            f"vs float64 twin: kernel {float((g.double() - e).abs().max()):.3e}, "
            f"twin {float((w.double() - e).abs().max()):.3e}")
        if not ok:
            raise AssertionError(f"kernel vs twin {where}: {name}' off by {err:.3e}")
        if not bool((g[0, n_live:] == 0).all()):
            raise AssertionError(f"kernel vs twin {where}: padded {name}' slots not 0")
    return float((got[0] - want[0]).abs().max())


def phase_kernel(seed: int) -> dict:
    from betacores_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = {"main": dict(n_sub=N_OPT, M_buf=M_BUF, n_live=60, d=N_FEAT, S_true=S,
                           packed=True),
              "ragged": dict(n_sub=37, M_buf=19, n_live=11, d=7, S_true=45, packed=False)}
    err_main, times = 0.0, {}
    for label, shp in shapes.items():
        ops, s_true = step_operands(gen, dev, **shp)
        for use_beta in (True, False):
            where = (f"[{label}: R={ops[0].shape[0]}, d={shp['d']}, S={s_true}, "
                     f"M_pad={ops[4].shape[1]}, beta={use_beta}]")
            got = kernels.logreg_adam_step(*ops, s_true, use_beta=use_beta)
            want = kernels.logreg_adam_step_plain(*ops, s_true, use_beta)
            exact = kernels.logreg_adam_step_plain(*(o.double() for o in ops), s_true,
                                                   use_beta)
            torch.cuda.synchronize()
            err = _compare(got, want, exact, shp["n_live"], where)
            if label == "main":
                err_main = max(err_main, err)
        if label == "main":
            step = lambda f: (lambda: f(*ops, s_true, use_beta=True))
            # turns: plain, kernel, kernel, plain
            t = [_time_ms(step(kernels.logreg_adam_step_plain), 200),
                 _time_ms(step(kernels.logreg_adam_step), 2000),
                 _time_ms(step(kernels.logreg_adam_step), 2000),
                 _time_ms(step(kernels.logreg_adam_step_plain), 200)]
            times = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2}
            log(f"time per step at the main path's shapes (CUDA events): kernel "
                f"{t[1] * 1e3:.2f} / {t[2] * 1e3:.2f} us, plain twin "
                f"{t[0] * 1e3:.2f} / {t[3] * 1e3:.2f} us")
    return {"max_abs_err": err_main, **times}


def phase_main_path(seed: int, n: int, selections: int, dev: str = "cuda") -> dict:
    from betacores_tpu_torch import (IncrementalConfig, gen_synthetic_logreg, init_state,
                                     logreg, logreg_laplace_sampler,
                                     make_incremental_builder, perturb_logreg)
    from betacores_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    X, y, _ = gen_synthetic_logreg(gen, n, d=N_FEAT)
    X, y, Z, out = perturb_logreg(gen, X, y, f_rate=0.1)
    torch.cuda.synchronize()
    log(f"data: N={n} x d={N_FEAT} on {Z.device}, {len(out)} corrupted rows, "
        f"made in {time.perf_counter() - t0:.2f} s")
    cfg = IncrementalConfig(projection_dim=S, n_subsample_select=N_SEL,
                            n_subsample_opt=N_OPT, opt_itrs=OPT_ITRS, i0=1.0,
                            use_beta=True)
    builder = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg)
    draws = builder.generator_draws(gen)
    st0 = init_state(M_BUF, N_FEAT, beta=BETA, device=dev)
    t0 = time.perf_counter()
    builder.build(st0, 1, draws)                     # warm-up selection
    torch.cuda.synchronize()
    log(f"warm-up selection: {time.perf_counter() - t0:.2f} s")

    kernels.logreg_adam_step.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    st = builder.build(st0, selections, draws)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.logreg_adam_step.launches

    want = selections * OPT_ITRS
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, want {want}")
    w, m = st.wts, int(st.m)
    if not bool(torch.isfinite(w).all()) or not bool((w >= 0).all()) or float(w.sum()) <= 0:
        raise AssertionError(f"bad weights: {w.tolist()}")
    if m < 1:
        raise AssertionError("no point selected")
    if bool((w[m:] != 0).any()) or bool((st.idcs[m:] != -1).any()):
        raise AssertionError("slots beyond m are not padding")
    secs = start.elapsed_time(end) / 1e3
    log(f"main path: {selections} selections x {OPT_ITRS} steps, m={m} "
        f"(fill {m / selections:.2f}), {launches} kernel launches, sum(w)={float(w.sum()):.1f}")
    log(f"build: {secs:.3f} s (CUDA events), {wall:.3f} s host clock, "
        f"{secs / selections * 1e3:.1f} ms per selection, "
        f"{secs / want * 1e6:.1f} us per Adam step")
    return {"launches": launches}


def phase_self_check(seed: int, dev: str = "cuda") -> None:
    """The small build of tests/test_torch_incremental.py, through the kernel
    on the card and through the plain twin on the CPU, on one set of draws:
    reference-parity select with a refit every step, and dedup select with
    a refit every 4th step."""
    from betacores_tpu_torch import (FixedDraws, IncrementalConfig, init_state, logreg,
                                     logreg_laplace_sampler, make_incremental_builder)

    N, D, M, S_s, itrs = 1500, 5, 15, 40, 8
    gen = torch.Generator().manual_seed(seed)
    th = torch.randn(D, generator=gen)
    X = torch.randn((N, D), generator=gen)
    y = torch.where(X @ th + 0.3 * torch.randn(N, generator=gen) > 0, 1.0, -1.0)
    Z = y[:, None] * X
    for dedup, refit_every in ((False, 1), (True, 4)):
        cfg = IncrementalConfig(projection_dim=S_s, n_subsample_select=150,
                                n_subsample_opt=150, opt_itrs=25, i0=0.5, use_beta=True,
                                dedup_select=dedup, refit_every=refit_every)
        st0 = init_state(M, D, beta=0.2)
        rec = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(),
                                       cfg).generator_draws(gen)
        draws = FixedDraws([rec.select(i, st0) for i in range(itrs)],
                           [rec.optimize(i, st0) for i in range(itrs)])
        out = {}
        for where in ("cpu", dev):
            b = make_incremental_builder(Z.to(where), logreg.bundle(),
                                         logreg_laplace_sampler(), cfg)
            st = b.build(init_state(M, D, beta=0.2, device=where), itrs, draws)
            out[where] = (st.wts.cpu(), st.idcs.cpu(), int(st.m))
        (w0, i0, m0), (w1, i1, m1) = out["cpu"], out[dev]
        where = f"dedup_select={dedup}, refit_every={refit_every}"
        if m0 != m1 or not torch.equal(i0, i1):
            raise AssertionError(f"selections differ ({where}): cpu m={m0} {i0.tolist()}, "
                                 f"{dev} m={m1} {i1.tolist()}")
        tol = 5e-3 * max(1.0, float(w0.abs().max()))
        err = float((w1 - w0).abs().max())
        if err > tol:
            raise AssertionError(f"weights differ ({where}) by {err:.3e} > {tol:.3e}")
        log(f"self-check [{where}]: kernel build == twin build (m={m1}, same indices, "
            f"max |dw| {err:.2e} <= {tol:.2e})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--selections", type=int, default=5)
    args = ap.parse_args()

    name = phase_device()
    phase_build()
    kern = phase_kernel(args.seed)
    main_path = phase_main_path(args.seed, N_ROWS, args.selections)
    phase_self_check(args.seed)
    print(json.dumps({"kernels": [{
        "name": "logreg_adam_step", "route": "cuda",
        "source": "betacores_tpu_torch/csrc/logreg_adam_step.cu",
        "replaces": "betacores_tpu/ops/pallas_kernels.py:96",
        "launches": main_path["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
