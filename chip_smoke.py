"""Smoke test of the PyTorch/CUDA port (betacores_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--selections 5] [--mc-selections 3]
                          [--sharded-selections 3] [--api-selections 5]
                          [--group-selections 3]

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit. Phases, each of which raises on failure:

  0. device: requires CUDA; prints the card's name and power limit; turns
     TF32 off for float32 products;
  1. build: compiles the hand-written kernels (betacores_tpu_torch/csrc/),
     one nvcc per source, all started together, for sm_90a, and prints
     what ptxas reports (registers and spills of each library's kernels,
     and of K2's kernel at the multiclass path's shape);
  2. K1 (the fused refinement step, one thread-block cluster per launch)
     against its plain version on the card, at the main path's shapes and
     at one ragged shape, with and without the beta-likelihood, within
     atol = rtol = 2e-4, printing the cluster size C the wrapper chose; at
     the main path's shape times the kernel at every C of 1..16 beside the
     empty-cluster floor, the interleaved row split against the contiguous
     one, and the kernel (graph-captured) against its plain version (CUDA
     events) and its roofline bound (``step_kernel_times``);
  3. K2 (the multiclass projection) against its plain version on the card,
     at the multiclass path's shape (N = 2^20, S = 100, K = 5, d = 10), at
     a ragged one and at one with theta in shared memory (d = 32, K = 16,
     S = 111), with and without the beta-likelihood (beta = 0.3), within
     atol 2e-5, and off the float64 plain version by at most twice the
     float32 plain version's own error; at the main shape times both in
     turns with CUDA events beside the bound (``mc_bound``: the
     beta-likelihood's operations, as timed) and the floor (a write-only
     kernel of the same grid storing the same block), and the crossover
     with the plain version at 260 to 65,536 rows;
  4. the logistic-regression main path: the beta-Cores incremental build of
     bench.py (N = 1M contaminated rows, d = 10, S = 100, 1000-row select
     subsample, 500 Adam steps on 200 rows per selection, 128-slot buffer,
     beta = 0.1) for --selections selections, every refinement pass
     replayed as CUDA graphs (the builder's default on a card) and every
     Adam step through K1 (the count of launches includes the replayed
     ones); then the same selections from the same state under the same
     draws with ``graph=False`` (each step dispatched from Python), which
     must give the same indices and m and weights within 1e-6 max|w|;
     prints both times per Adam step;
  5. that slice against itself: a small build through K1 equals the same
     build through the plain version on the CPU under replayed draws, in
     reference-parity select and in dedup select with lagged refits;
  6. the multiclass path: the beta-Cores build of examples/multiclass.py
     (N = 2^20 rows, K = 5, d = 10, 20 % label flips, S = 100, 60-slot
     buffer, beta = 0.3, 200 Adam steps on 200 rows per selection) with
     full-candidate select, for --mc-selections selections after a warm-up
     one, every select launching K2 once, the composed refinement route
     captured and then eager as in phase 4; prints the select and
     refinement time per selection and the test accuracy of the coreset's
     posterior;
  7. that slice against itself: a small full-select multiclass build
     (N = 9000, so select launches K2) on the card equals the same build
     on the CPU under replayed draws, in both select modes;
  8. K3 (the sharded step's shard-local partials) against its plain
     version on the card, at the (1, 1) mesh's full width, at a (., 2)
     mesh's shape and at a ragged unpadded shape, with and without the
     beta-likelihood: each output within 2e-4 of its largest magnitude,
     padding exactly 0, and the gradient assembled from the partials
     within 3e-4 of the centred gradient's largest magnitude; times it as
     phase 2 times K1;
  9. the sharded headline build: the bench.py configuration on a (1, 1)
     mesh, one process in an NCCL process group of one rank (met through
     a FileStore in a temporary directory), for --sharded-selections
     selections after a warm-up one, every Adam step launching K3 and no
     step K1, its two all-reduces inside the captured step; prints the
     collective counts (replayed ones included); then eager as in phase 4;
 10. that slice against itself: a small sharded build through K3 on the
     card equals the same build through K3's plain version on the CPU (a
     gloo group of one rank) and the single-device build through K1 on the
     card, under one set of draws, in both select modes;
 11. the entry point: ``bench_torch.run`` at 3 selections of the headline
     configuration (a warm-up build and a timed one), whose record must
     hold a positive time and a fill;
 12. the object API (``import betacores_tpu_torch as bc``) at the
     headline's full width, on data made on the card (``phase_api``):
     ``bc.BetaCoreset`` (a warm-up ``build(1, 1)``, then
     ``build_trace(--api-selections)``, every Adam step through K1), which
     must equal the functional builder's build from the same state under
     the same generator (same ``idcs`` and m, w within 1e-6 max|w|);
     ``bc.SparseVICoreset`` for 3 selections (K1's ll variant);
     ``optimize()`` on the beta-Cores coreset, with ``error()`` before and
     after, whose kept state must be tensors of its own; ``learn_beta``
     for 2 selections captured and then eager from the same seed (agreeing
     as phase 4's builds do, beta within [1e-3, 1] and moved, no K1),
     after timing the process's first forward-mode derivative apart; the
     diagonal Laplace sampler for 2 selections through K1, across a
     buffer growth from 64 to 128 slots; ``bc.UniformSamplingCoreset`` for
     100 points and at the beta-Cores coreset's size; the multiclass
     ``bc.BetaCoreset`` of phase 6 for 2 selections (K2 once per select);
     and the held-out test accuracy of each logistic coreset's Laplace
     posterior side by side. Every run prints its seconds per selection
     and per Adam step;
 13. the model families (``phase_families``): the Gaussian, Poisson,
     unknown-covariance Gaussian and linear-regression builds through the
     object API at their examples' widths over 2^20 rows, captured and
     eager, with no kernel of the repo on their path;
 14. the Hilbert slice (``phase_hilbert``), in float32: the Hilbert
     coresets of examples/zellner_gaussian.py (d = 100, S = 200, M = 200)
     over 2^20 rows plus outliers, GIGAO and GIGAR by
     ``snnls.build_trace(200)`` (the error never rises and ends below
     ||b||; a trace row equals a build of that length; one GIGA build of
     200 under ``torch.cuda.set_sync_debug_mode("error")``, so a host read
     in the greedy loop fails) and IHTO by one AccIHT ``build(200)``;
     ``refine()`` of the Gaussian ``SparseVICoreset`` at S_big = 500 with
     its reverse KL before and after; ``ShardedHilbertCoreset`` on a (1, 1)
     NCCL mesh in ll and beta (0.3) modes, which must take the
     single-device GIGA's columns with weights within 1e-6 max|w|; Frank-
     Wolfe, OMP and LAR at the example's N = 5000, whose columns must be the
     CPU float64 solver's at every iteration (LAR's in float64: float32
     departs), and the sampling solvers folding the same draws as the CPU;
     the multiclass ``HilbertCoreset`` of examples/multiclass.py's widths
     (one K2 launch) with its held-out accuracy; ``refine()`` of a
     multiclass ``SparseVICoreset`` over every row (one more K2 launch, at
     S = 500, which is timed and held against its plain version). Every run
     prints its seconds and ms per greedy iteration;
 15. group selection, the pseudo-coresets and data valuation
     (``phase_groups``): (a) examples/group_selection.py on the repo's
     movielens data and groups (corrupted as the example does), the group
     ``BetaCoreset`` (one-hot group reduction) by ``build_trace(...,
     return_selected=True)``, distributional and truncated Monte-Carlo
     Shapley with the Laplace value function, and the BCORES order's prefix
     accuracies; (b) the logistic group build of
     examples/bench_group_pass.py --end-to-end (N = 1M, 100 groups of 10,000,
     exact-gradient refinement, scatter reduction) for --group-selections
     selections after a warm-up, captured and then eager under the same
     draws; (c) a multiclass group build at examples/multiclass.py's widths
     (N = 2^20, 128 groups of 8192, a 4-group buffer) whose every select and
     refinement step launches K2 over every row and over the buffer, then
     that build at N = 9000 on the card against the CPU; (d) BPSVI at
     examples/zellner_logreg.py's widths over 1M rows
     (``BatchPSVICoreset.build(1, 100)``, ``bpsvi_build_batch`` over sizes
     10, 50, 100, each lane equal to its standalone masked build); (e)
     DP-BPSVI at examples/dp_bpsvi.py's defaults with its epsilon, and
     ``PseudoSparseVICoreset`` for 5 selections on that data.

The last two lines of standard output are a JSON object describing the
kernels (K1 and K3 add ``bound_us`` and ``floor_us``, K2 ``floor_ms``), then
{"ok": true, "device": {...}}. Without a card the script exits nonzero and
prints neither.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL = 2e-4                      # K1 vs its plain version, float32 (the reference's own)
MC_TOL = 2e-5                   # K2 vs its plain version (the reference's own)
GRAD_TOL = 3e-4                 # K3's assembled gradient vs the centred one (the reference's own)
GRAPH_TOL = 1e-6                # a captured build's weights vs the eager build's, of max|w|
# the headline configuration of bench.py
N_ROWS, N_FEAT, S, BETA = 1_000_000, 10, 100, 0.1
N_SEL, N_OPT, OPT_ITRS, M_BUF = 1000, 200, 500, 128
# the configuration of examples/multiclass.py, at 2^20 rows with full select
MC_ROWS, MC_K, MC_D, MC_BETA, MC_F_RATE = 1 << 20, 5, 10, 0.3, 0.2
MC_M, MC_N_OPT, MC_OPT_ITRS, MC_N_TEST = 60, 200, 200, 10_000
# K2's instantiation at that shape (K = 5, theta in registers with D = 10)
MC_MAIN_KERNEL = "multiclass_projection_kernelILi5ELi10E"
KERNELS = ("logreg_adam_step", "multiclass_projection", "logreg_shard_partials")
# phase 13: the model families at their reference examples' widths, N scaled to 2^20,
# each driven for FAM_SELECTIONS selections
FAM_ROWS, FAM_SELECTIONS = 1 << 20, 3
# examples/zellner_gaussian.py:38-46
G_D, G_M, G_S, G_ITRS, G_N_OPT, G_N_SEL, G_BETA, G_I0 = 100, 200, 200, 1000, 200, 1000, 0.1, 0.1
# and at that example's own N, where its i0 moves the weights within a few
# selections: BCORES's reverse KL must fall G_GAIN below the prior's (an
# empty coreset is the prior) and take in no outlier row
G_EXAMPLE_N, G_EXAMPLE_SELECTIONS, G_GAIN = 5000, 20, 0.01
# examples/poisson_regression.py:59-66,113-115 (synth_poiss's d = 5)
P_D, P_M, P_S, P_ITRS, P_N_OPT, P_N_SEL, P_BETA, P_I0 = 5, 50, 100, 300, 200, 500, 0.3, 1.0
P_F_RATE, P_SHIFT = 0.1, 50.0
# examples/mvn_unknown_cov.py:38-47,78-81
V_D, V_M, V_S, V_ITRS, V_N_OPT, V_N_SEL, V_BETA, V_I0 = 4, 30, 64, 150, 200, 500, 0.5, 1.0
V_F_RATE, V_SHIFT = 0.1, 10.0
# examples/zellner_neural_linear.py:57-66,140 (its --D, S, steps, rows, i0, beta, M)
L_D, L_M, L_S, L_ITRS, L_N_OPT, L_N_SEL, L_BETA, L_I0 = 12, 20, 100, 500, 1000, 1000, 0.5, 0.1
# H100 SXM peaks at its 700 W limit: float32 outside the tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# phase 14, the Hilbert slice at the same Gaussian's widths: the example's
# --pihat-noise (GIGAR's mis-tuning), the trace row held against a build,
# the SparseVI selections refine() polishes, refine()'s S_big, the sharded
# build's beta and the other solvers' budget at the example's N
H_PIHAT, H_ROW, H_SVI_SELECTIONS, H_REFINE_S, H_BETA, H_OTHER_M = 0.75, 50, 3, 500, 0.3, 50
# phase 15: examples/group_selection.py's defaults (M groups, S, Adam steps,
# refinement rows, beta, corruption rate) and its Shapley runs (T, cap, groups
# a permutation; TMC's T)
GRP_M, GRP_S, GRP_ITRS, GRP_N_OPT, GRP_BETA, GRP_F_RATE = 10, 100, 200, 500, 0.2, 0.1
SHAP_T, SHAP_CAP, SHAP_GROUPS, TMC_T = 50, 50, 20, 5
# examples/bench_group_pass.py --end-to-end (N, G, the buffer's M groups, steps),
# and its multiclass counterpart at examples/multiclass.py's widths
GB_N, GB_G, GB_M, GB_ITRS, GB_BETA = 1_000_000, 100, 20, 100, 0.1
GC_N, GC_G, GC_BUF_GROUPS, GC_ITRS = 1 << 20, 128, 4, 200
# examples/zellner_logreg.py's BPSVI (M, steps) and the batch's lane sizes
BP_M, BP_ITRS, BP_SIZES = 100, 500, (10, 50, 100)
# examples/dp_bpsvi.py's defaults, and PSVI's selections on its data
DP_N, DP_D, DP_M, DP_ITRS, DP_N_OPT, DP_NM, DP_DELTA = 5000, 10, 30, 300, 500, 1.0, 1e-5
PSVI_SELECTIONS = 5
CLUSTERS = (1, 2, 4, 8, 16)     # K1's and K3's cluster sizes, timed in phases 2 and 8
N_TEST = 10_000                 # held-out rows of the object API's accuracy check
# operations per likelihood value (csrc/logreg_common.cuh::Likelihood),
# each arithmetic or transcendental operation counted once: beta, log
TRANSFORM_OPS = {True: 17, False: 6}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> tuple:
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
    return name, smi


def phase_build() -> None:
    from betacores_tpu_torch.ops import _build, kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source, together
        paths = list(pool.map(_build.library_path, KERNELS))
    kernels._lib()
    kernels._mc_lib()
    kernels._shard_lib()
    log(f"build: {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.2f} s")
    for path in paths:
        report = path.with_suffix(".log")
        if not report.exists():
            continue
        lib = path.name.split("-")[0]
        funcs = ptxas_report(report.read_text())
        if not funcs:
            raise RuntimeError(f"no ptxas report in {report}")
        regs = [f["registers"] for f in funcs.values()]
        spills = {name: f for name, f in funcs.items() if f["spill_stores"] or f["spill_loads"]}
        log(f"  ptxas {lib}: {len(funcs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{len(spills)} with spills {sorted(spills)}")
        for name, f in funcs.items():
            if lib == "libmulticlass_projection" and MC_MAIN_KERNEL in name:
                log(f"  ptxas {lib}: the main shape's kernel {name}: {f}")


def ptxas_report(text: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack}} from the
    output of ``nvcc -Xptxas -v``."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            funcs.setdefault(name, {"registers": 0, "spill_stores": 0, "spill_loads": 0,
                                    "stack": 0})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            funcs[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            funcs[name]["registers"] = int(m.group(1))
    return funcs


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


def _graph_us(fn, n: int = 200) -> float:
    """Device time per call of ``fn`` in us: ``n`` calls captured in one
    CUDA graph, replayed five times, the median replay over ``n``. ``fn``
    runs once before the capture, so a kernel's shared-memory and cluster
    attributes are set outside it. The wrapper's host time is not in the
    reading: at a few us a kernel is shorter than its own Python wrapper."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / n)
    return sorted(times)[2]


def step_bound(ops, s_true: int, use_beta: bool, adam: bool) -> dict:
    """The least time the card could take for one K1 (``adam``) or K3
    launch on these operands: the larger of the bytes it must move (each
    input read once, each output written once) over 3.35 TB/s and its
    float32 operations over 67 TFLOP/s. Operations count what these
    operands need: theta (2 S d^2), and for each live row's values the dot
    product, the transform, the mask and the sums; K1 adds the centred
    gradient and the Adam update."""
    xin, z, w = ops[0], ops[1], ops[4]
    R, D1 = xin.shape
    d, M_pad, s_pad = D1 - 1, w.shape[1], z.shape[0]
    live = xin[:, d] != 0
    n_live, n_core_live = int(live.sum()), int(live[R - M_pad:].sum())
    flops = (2 * s_true * d * d + n_live * s_true * (2 * d + TRANSFORM_OPS[use_beta] + 2)
             + n_core_live * s_true * 4)
    nbytes = 4 * (R * D1 + s_true * d + d + d * d)
    if adam:   # w, m1, m2, sc, sclr in; w', m1', m2' out
        flops += 12 * M_pad
        nbytes += 4 * (3 * M_pad + 5 + 3 * M_pad)
    else:      # w, sc in; colsum, core, corerow, wcore out
        nbytes += 4 * (M_pad + 1 + 2 * s_pad + M_pad * s_pad + M_pad)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def contiguous_split(xin, slots, n_sub_pad: int, C: int):
    """Operands on which the kernels' interleaved split
    (ops/kernels.py::cluster_rows) hands each CTA the rows a contiguous
    split would: CTA c gets subsample rows [c a, (c+1) a) and buffer slots
    [c b, (c+1) b), a = ceil(n_sub_pad / C), b = M_pad / C. The subsample
    is padded to C a rows with masked ones. ``slots`` are (1, M_pad)
    per-slot operands. Returns (xin', slots', old): new slot p holds old
    slot old[p]."""
    M_pad = slots[0].shape[1]
    if M_pad % C:
        raise ValueError(f"M_pad={M_pad} is not a multiple of C={C}")
    a, b = -(-n_sub_pad // C), M_pad // C
    p = torch.arange(C * a, device=xin.device)
    old_r = (p % C) * a + p // C
    keep = old_r < n_sub_pad
    sub = torch.zeros((C * a, xin.shape[1]), dtype=xin.dtype, device=xin.device)
    sub[keep] = xin[old_r[keep]]
    q = torch.arange(M_pad, device=xin.device)
    old = (q % C) * b + q // C
    return (torch.cat([sub, xin[n_sub_pad + old]]).contiguous(),
            [t[:, old].contiguous() for t in slots], old)


def step_kernel_times(tag: str, wrapper, plain, launch, floor, ops, s_true: int,
                      slot_args: tuple, adam: bool) -> dict:
    """Times K1 or K3 at the main path's shape, beta on:
    - the kernel at each cluster size in CLUSTERS, graph-captured
      (``_graph_us``), beside the floor: an empty kernel of the same
      cluster geometry and shared memory with both cluster barriers;
    - at the chosen size, the interleaved split against the contiguous one
      (``contiguous_split``), K1's result checked on the permuted rows;
    - in turns plain, kernel, kernel, plain: the plain version in a loop
      of CUDA events (as it runs, paced by the host) and the wrapper
      graph-captured;
    - the wrapper in a loop of CUDA events, the reading of earlier PRs,
      which counts the wrapper's host time.
    Returns the kernel's entries of the kernels line."""
    from betacores_tpu_torch.ops import kernels

    xin = ops[0]
    R, D1 = xin.shape
    M_pad = ops[4].shape[1]
    C = kernels.cluster_size(R)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def floor_at(c):
        def run():
            rc = floor(R, D1 - 1, s_true, M_pad, c, stream())
            if rc != 0:
                raise RuntimeError(f"{tag} floor launch of a {c}-CTA cluster failed: cudaError {rc}")
        return run

    floor_us = None
    for c in CLUSTERS:
        t = _graph_us(lambda: launch(*ops, s_true, True, c))
        f = _graph_us(floor_at(c))
        log(f"{tag} at C={c}{' (chosen)' if c == C else ''}: {t:.2f} us per launch, "
            f"floor {f:.2f} us (graph-captured)")
        if c == C:
            floor_us = f
    xin_c, slots_c, old = contiguous_split(xin, [ops[i] for i in slot_args], R - M_pad, C)
    ops_c = list(ops)
    ops_c[0] = xin_c
    for i, t in zip(slot_args, slots_c):
        ops_c[i] = t
    if adam:
        got = launch(*ops_c, s_true, True, C)[0]
        want = plain(*ops, s_true, True)[0][:, old]
        if not torch.allclose(got, want, atol=TOL, rtol=TOL):
            raise AssertionError(f"{tag} on contiguously split rows: w' off by "
                                 f"{float((got - want).abs().max()):.3e}")
    t_int = [_graph_us(lambda: launch(*ops, s_true, True, C)),
             _graph_us(lambda: launch(*ops_c, s_true, True, C))]
    t_int += [_graph_us(lambda: launch(*ops_c, s_true, True, C)),
              _graph_us(lambda: launch(*ops, s_true, True, C))]
    log(f"{tag} row split at C={C} (graph-captured): interleaved {t_int[0]:.2f} / "
        f"{t_int[3]:.2f} us, contiguous {t_int[1]:.2f} / {t_int[2]:.2f} us")
    call = lambda f: (lambda: f(*ops, s_true, use_beta=True))
    # turns: plain, kernel, kernel, plain
    t = [_time_ms(call(plain), 200) * 1e3, _graph_us(call(wrapper)),
         _graph_us(call(wrapper)), _time_ms(call(plain), 200) * 1e3]
    loop_us = _time_ms(call(wrapper), 2000) * 1e3
    bound = step_bound(ops, s_true, True, adam)
    log(f"{tag} per launch at the main path's shape, C={C}: kernel {t[1]:.2f} / {t[2]:.2f} us "
        f"(graph-captured), floor {floor_us:.2f} us, bound {bound['bound_ms'] * 1e3:.4f} us "
        f"by {bound['bound_by']} ({bound['flops']} float32 operations, {bound['bytes']} B); "
        f"plain {t[0]:.2f} / {t[3]:.2f} us (CUDA events); the wrapper in a CUDA-event "
        f"loop {loop_us:.2f} us")
    return {"ms": (t[1] + t[2]) / 2e3, "plain_ms": (t[0] + t[3]) / 2e3,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
            "bound_us": bound["bound_ms"] * 1e3, "floor_us": floor_us}


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
    """K1 against its plain version on the card (see ``_compare``)."""
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
                     f"M_pad={ops[4].shape[1]}, C={kernels.cluster_size(ops[0].shape[0])}, "
                     f"beta={use_beta}]")
            got = kernels.logreg_adam_step(*ops, s_true, use_beta=use_beta)
            want = kernels.logreg_adam_step_plain(*ops, s_true, use_beta)
            exact = kernels.logreg_adam_step_plain(*(o.double() for o in ops), s_true,
                                                   use_beta)
            torch.cuda.synchronize()
            err = _compare(got, want, exact, shp["n_live"], where)
            if label == "main":
                err_main = max(err_main, err)
        if label == "main":
            times = step_kernel_times("K1", kernels.logreg_adam_step,
                                      kernels.logreg_adam_step_plain, kernels.launch_adam_step,
                                      kernels._lib().logreg_adam_step_floor, ops, s_true,
                                      (4, 5, 6), adam=True)
    return {"max_abs_err": err_main, **times}


def mc_operands(gen, dev, N, S_true, K, d):
    """Random operands of one K2 launch: rows [x | y] with x ~ N(0, I) and
    a float class index y, and packed thetas ~ N(0, I)."""
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.randn((N, d), generator=gen, **f32)
    y = torch.randint(0, K, (N, 1), generator=gen, device=dev).to(torch.float32)
    th = torch.randn((S_true, K * d), generator=gen, **f32)
    return torch.cat([x, y], dim=1).contiguous(), th


def mc_bound(N: int, S_true: int, K: int, d: int, use_beta: bool) -> dict:
    """The least time the card could take for one K2 launch: the larger of
    its bytes (z and thetas read once, the (N, S) block written once) over
    3.35 TB/s and its float32 operations over 67 TFLOP/s, each operation
    counted once. Per value: per class the logit (2 d) and the softmax's
    max, exp and sum (3), with the beta-likelihood also the mass term's
    subtract, multiply, exp and add (4); then the log and the label pick
    (2), with beta the exp of beta lp_y and its scale (2), and the
    centring's add and subtract (2): K (2 d + 7) + 6 with beta."""
    per_value = K * (2 * d + 3 + (4 if use_beta else 0)) + 4 + (2 if use_beta else 0)
    flops = N * S_true * per_value
    nbytes = 4 * (N * (d + 1) + S_true * K * d + N * S_true + 1)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def phase_mc_kernel(seed: int) -> dict:
    """K2 against its plain version on the card: max |kernel - plain| within
    atol 2e-5 at the main, a ragged and a shared-theta shape, beta off and
    on. Both are also held against the plain version in float64 (by row
    chunks, to bound its (N, S, K) intermediates), printed for scale. At the
    main shape, beta on, times the kernel and its plain version in turns
    (CUDA events) beside the bound (``mc_bound``) and the floor: a
    write-only kernel of the same grid storing the same (N, S) block."""
    from betacores_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    beta = torch.full((), MC_BETA, dtype=torch.float32, device=dev)
    shapes = {"main": dict(N=MC_ROWS, S_true=S, K=MC_K, d=MC_D),
              "ragged": dict(N=700, S_true=50, K=4, d=6),
              "shared theta": dict(N=20_000, S_true=111, K=16, d=32)}
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    err_main, times = 0.0, {}
    for label, shp in shapes.items():
        z, th = mc_operands(gen, dev, **shp)
        plan = kernels.mc_plan_built(shp["d"], shp["K"], shp["S_true"], limit)
        log(f"K2 plan [{label}]: {plan} (D = 0: theta in shared memory)")
        for use_beta in (False, True):
            where = f"[{label}: N={shp['N']}, S={shp['S_true']}, K={shp['K']}, d={shp['d']}, beta={use_beta}]"
            got = kernels.multiclass_projection(z, th, shp["K"], beta, use_beta)
            want = kernels.multiclass_projection_plain(z, th, shp["K"], beta, use_beta)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            e_k = e_p = 0.0
            for r in range(0, shp["N"], 1 << 18):
                ex = kernels.multiclass_projection_plain(
                    z[r:r + (1 << 18)].double(), th.double(), shp["K"], beta.double(), use_beta)
                e_k = max(e_k, float((got[r:r + (1 << 18)].double() - ex).abs().max()))
                e_p = max(e_p, float((want[r:r + (1 << 18)].double() - ex).abs().max()))
            log(f"  K2 {where}: max|kernel-plain| {err:.3e} (max|plain| "
                f"{float(want.abs().max()):.3e}); vs float64 plain: kernel {e_k:.3e}, "
                f"plain {e_p:.3e}")
            if not err <= MC_TOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K2 vs plain {where}: off by {err:.3e} > {MC_TOL}")
            if not e_k <= 2 * e_p:
                raise AssertionError(f"K2 {where}: {e_k:.3e} off the float64 plain version, "
                                     f"more than twice the float32 plain version's {e_p:.3e}")
            if label == "main":
                err_main = max(err_main, err)
        if label == "main":
            call = lambda f: (lambda: f(z, th, MC_K, beta, True))
            # turns: plain, kernel, kernel, plain
            t = [_time_ms(call(kernels.multiclass_projection_plain), 20),
                 _time_ms(call(kernels.multiclass_projection), 200),
                 _time_ms(call(kernels.multiclass_projection), 200),
                 _time_ms(call(kernels.multiclass_projection_plain), 20)]
            out = torch.empty((MC_ROWS, S), dtype=torch.float32, device=dev)

            def floor():
                rc = kernels._mc_lib().multiclass_projection_floor(
                    out.data_ptr(), MC_ROWS, MC_D, MC_K, S,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"K2 floor launch failed: cudaError {rc}")

            floor_ms = _time_ms(floor, 200)
            del out
            bound = mc_bound(MC_ROWS, S, MC_K, MC_D, True)
            times = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                     "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                     "floor_ms": floor_ms, "library_ms": None}
            log(f"K2 bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
                f"({bound['flops']} float32 operations, {bound['bytes']} B); floor "
                f"{floor_ms:.4f} ms (CUDA events)")
            log(f"K2 time per projection at N={MC_ROWS}, S={S}, K={MC_K}, d={MC_D}, beta "
                f"(CUDA events): kernel {t[1]:.4f} / {t[2]:.4f} ms, plain "
                f"{t[0]:.4f} / {t[3]:.4f} ms")
        del z, th
    torch.cuda.empty_cache()
    # where the kernel overtakes the plain version, against the projection
    # engine's FUSED_MIN_ROWS (taken over from the TPU)
    for n in (260, 1024, 4096, 8192, 65536):
        z, th = mc_operands(gen, dev, n, S, MC_K, MC_D)
        call = lambda f: (lambda: f(z, th, MC_K, beta, True))
        t = [_time_ms(call(f), 50) for f in (kernels.multiclass_projection_plain,
                                              kernels.multiclass_projection,
                                              kernels.multiclass_projection,
                                              kernels.multiclass_projection_plain)]
        log(f"K2 crossover at N={n}: kernel {(t[1] + t[2]) / 2:.4f} ms, plain "
            f"{(t[0] + t[3]) / 2:.4f} ms (FUSED_MIN_ROWS = {kernels.FUSED_MIN_ROWS})")
    return {"max_abs_err": err_main, **times}


def check_state(st):
    """(weights, m) of a built state, which must hold finite, non-negative
    weights with a positive sum, at least one point, and padding (weight 0,
    index -1) in every slot beyond m."""
    w, m = st.wts, int(st.m)
    if not bool(torch.isfinite(w).all()) or not bool((w >= 0).all()) or float(w.sum()) <= 0:
        raise AssertionError(f"bad weights: {w.tolist()}")
    if m < 1:
        raise AssertionError("no point selected")
    if bool((w[m:] != 0).any()) or bool((st.idcs[m:] != -1).any()):
        raise AssertionError("slots beyond m are not padding")
    return w, m


def check_same_build(what: str, got, ref) -> str:
    """Raises unless two built states select the same indices and m, with
    weights within 5e-3 * max(1, max|w_ref|); returns a summary."""
    w1, i1, m1 = got.wts.cpu(), got.idcs.cpu(), int(got.m)
    w0, i0, m0 = ref.wts.cpu(), ref.idcs.cpu(), int(ref.m)
    if m0 != m1 or not torch.equal(i0, i1):
        raise AssertionError(f"{what}: selections differ: m={m1} {i1.tolist()} against "
                             f"m={m0} {i0.tolist()}")
    tol = 5e-3 * max(1.0, float(w0.abs().max()))
    err = float((w1 - w0).abs().max())
    if err > tol:
        raise AssertionError(f"{what}: weights differ by {err:.3e} > {tol:.3e}")
    return f"m={m1}, same indices, max |dw| {err:.2e} <= {tol:.2e}"


def check_graph_equals_eager(what: str, got, ref) -> str:
    """Raises unless a build through replayed CUDA graphs and the same
    build dispatched from Python (same state, same draws) select the same
    indices and m, with weights within 1e-6 * max|w|: the two run the same
    kernels in the same order. Returns a summary."""
    if int(got.m) != int(ref.m) or not torch.equal(got.idcs, ref.idcs):
        raise AssertionError(f"{what}: captured and eager selections differ: m={int(got.m)} "
                             f"{got.idcs.tolist()} against m={int(ref.m)} {ref.idcs.tolist()}")
    scale = float(ref.wts.abs().max())
    err = float((got.wts - ref.wts).abs().max())
    if not err <= GRAPH_TOL * scale:
        raise AssertionError(f"{what}: captured and eager weights differ by {err:.3e} > "
                             f"{GRAPH_TOL * scale:.3e}")
    return f"same m={int(got.m)} and indices, max |dw| {err:.3e} <= {GRAPH_TOL * scale:.3e}"


def timed_build(builder, st0, selections: int, draws):
    """(state, seconds by CUDA events, seconds on the host clock) of one
    ``build``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    st = builder.build(st0, selections, draws)
    end.record()
    end.synchronize()
    return st, start.elapsed_time(end) / 1e3, time.perf_counter() - t0


def same_build_on_cpu(tag: str, make, Z, st_at, cfg, itrs: int, gen, dev: str,
                      kernel=None) -> None:
    """Runs one build on the CPU (plain versions) and on ``dev`` (kernels)
    under one set of draws recorded from ``gen``, and raises unless both
    select the same indices and m, with weights within
    5e-3 * max(1, max|w|). ``make(Z, cfg)`` makes the builder, ``st_at(dev)``
    the initial state. ``kernel`` (a wrapper with a launch count), when
    given, must launch once per selection on the card."""
    from betacores_tpu_torch import FixedDraws

    rec = make(Z, cfg).generator_draws(gen)
    st0 = st_at("cpu")
    draws = FixedDraws([rec.select(i, st0) for i in range(itrs)],
                       [rec.optimize(i, st0) for i in range(itrs)])
    out = {}
    for where in ("cpu", dev):
        before = kernel.launches if kernel else 0
        st = make(Z.to(where), cfg).build(st_at(where), itrs, draws)
        out[where] = (st, kernel.launches - before if kernel else 0)
    where = f"{tag} [dedup_select={cfg.dedup_select}, refit_every={cfg.refit_every}]"
    n_k = out[dev][1]
    if kernel and dev != "cpu" and n_k != itrs:
        raise AssertionError(f"{where}: kernel launched {n_k} times in the build, want {itrs}")
    summary = check_same_build(where, out[dev][0], out["cpu"][0])
    log(f"{where}: build on the card == build on the CPU ({summary})")


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

    if not builder.graph and dev == "cuda":
        raise AssertionError("the builder does not capture its passes on the card")
    gen_state = gen.get_state()
    kernels.logreg_adam_step.launches = 0
    st, secs, wall = timed_build(builder, st0, selections, draws)
    launches = kernels.logreg_adam_step.launches

    want = selections * OPT_ITRS
    if launches != want:
        raise AssertionError(f"kernel launched {launches} times, want {want}")
    w, m = check_state(st)
    log(f"main path: {selections} selections x {OPT_ITRS} steps, m={m} "
        f"(fill {m / selections:.2f}), {launches} kernel launches (replayed ones counted), "
        f"sum(w)={float(w.sum()):.1f}")
    log(f"build, passes captured: {secs:.3f} s (CUDA events), {wall:.3f} s host clock, "
        f"{secs / selections * 1e3:.1f} ms per selection, "
        f"{secs / want * 1e6:.1f} us per Adam step")
    # the same selections, each step dispatched from Python
    eager = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg,
                                     graph=False)
    gen.set_state(gen_state)
    st_e, secs_e, wall_e = timed_build(eager, st0, selections, eager.generator_draws(gen))
    log(f"build, passes eager: {secs_e:.3f} s (CUDA events), {wall_e:.3f} s host clock, "
        f"{secs_e / want * 1e6:.1f} us per Adam step")
    log(f"main path, captured == eager: {check_graph_equals_eager('main path', st, st_e)}")
    return {"launches": launches}


def phase_self_check(seed: int, dev: str = "cuda") -> None:
    """The small build of tests/test_torch_incremental.py, through K1 on the
    card and through its plain version on the CPU, on one set of draws:
    reference-parity select with a refit every step, and dedup select with
    a refit every 4th step."""
    from betacores_tpu_torch import (IncrementalConfig, init_state, logreg,
                                     logreg_laplace_sampler, make_incremental_builder)

    N, D, M, S_s, itrs = 1500, 5, 15, 40, 8
    gen = torch.Generator().manual_seed(seed)
    th = torch.randn(D, generator=gen)
    X = torch.randn((N, D), generator=gen)
    y = torch.where(X @ th + 0.3 * torch.randn(N, generator=gen) > 0, 1.0, -1.0)
    make = lambda Z, cfg: make_incremental_builder(Z, logreg.bundle(),
                                                   logreg_laplace_sampler(), cfg)
    for dedup, refit_every in ((False, 1), (True, 4)):
        cfg = IncrementalConfig(projection_dim=S_s, n_subsample_select=150,
                                n_subsample_opt=150, opt_itrs=25, i0=0.5, use_beta=True,
                                dedup_select=dedup, refit_every=refit_every)
        same_build_on_cpu("self-check", make, y[:, None] * X,
                          lambda where: init_state(M, D, beta=0.2, device=where),
                          cfg, itrs, gen, dev)


def phase_mc_path(seed: int, n: int, selections: int, dev: str = "cuda") -> dict:
    """The multiclass build of examples/multiclass.py with full-candidate
    select, on data made on the card. Runs build's loop (select, then
    optimize) with CUDA events between the halves."""
    from betacores_tpu_torch import (IncrementalConfig, flip_labels,
                                     gen_synthetic_multiclass, init_state,
                                     make_incremental_builder, multiclass,
                                     multiclass_laplace_sampler)
    from betacores_tpu_torch.inference import newton_laplace, sample_laplace_from_noise
    from betacores_tpu_torch.ops import kernels

    K, d = MC_K, MC_D
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    X, y, Z = gen_synthetic_multiclass(gen, n + MC_N_TEST, d=d, n_classes=K)
    Zc, bad = flip_labels(gen, Z[:n], K, MC_F_RATE)
    Xt, yt = X[n:], y[n:]
    torch.cuda.synchronize()
    log(f"multiclass data: N={n} x d={d}, K={K} on {Zc.device}, {len(bad)} flipped "
        f"labels, {MC_N_TEST} held-out rows, made in {time.perf_counter() - t0:.2f} s")
    cfg = IncrementalConfig(projection_dim=S, n_subsample_select=None,
                            n_subsample_opt=MC_N_OPT, opt_itrs=MC_OPT_ITRS, i0=1.0,
                            use_beta=True)
    builder = make_incremental_builder(Zc, multiclass.bundle(K),
                                       multiclass_laplace_sampler(K), cfg)
    draws = builder.generator_draws(gen)
    st0 = init_state(MC_M, d + 1, beta=MC_BETA, device=dev,
                     sampler_aux=torch.zeros(K * d, device=dev))
    t0 = time.perf_counter()
    builder.build(st0, 1, draws)                     # warm-up selection
    torch.cuda.synchronize()
    log(f"multiclass warm-up selection: {time.perf_counter() - t0:.2f} s")

    def halves(b, draws):
        """(state, select ms, refinement ms per selection) of build's loop
        with CUDA events between the halves."""
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(selections)]
        st = st0
        for it in range(selections):
            ev[it][0].record()
            st = b.select(st, draws, it)
            ev[it][1].record()
            st = b.optimize(st, draws, it)
            ev[it][2].record()
        ev[-1][2].synchronize()
        return (st, [e[0].elapsed_time(e[1]) for e in ev],
                [e[1].elapsed_time(e[2]) for e in ev])

    gen_state = gen.get_state()
    kernels.multiclass_projection.launches = 0
    kernels.logreg_adam_step.launches = 0
    st, sel_ms, opt_ms = halves(builder, draws)
    launches = kernels.multiclass_projection.launches
    if launches != selections or kernels.logreg_adam_step.launches != 0:
        raise AssertionError(f"K2 launched {launches} times, want {selections} "
                             f"(one per select); K1 {kernels.logreg_adam_step.launches}")
    eager = make_incremental_builder(Zc, multiclass.bundle(K), multiclass_laplace_sampler(K),
                                     cfg, graph=False)
    gen.set_state(gen_state)
    st_e, _, opt_ms_e = halves(eager, eager.generator_draws(gen))
    log(f"multiclass refinement per Adam step: captured "
        f"{sum(opt_ms) / selections / MC_OPT_ITRS * 1e3:.1f} us, eager "
        f"{sum(opt_ms_e) / selections / MC_OPT_ITRS * 1e3:.1f} us")
    log(f"multiclass path, captured == eager: "
        f"{check_graph_equals_eager('multiclass path', st, st_e)}")
    w, m = check_state(st)
    # test accuracy of the coreset's Laplace posterior (examples/multiclass.py)
    lj, g, h = (multiclass.make_log_joint(K), multiclass.make_grad_th_log_joint(K),
                multiclass.make_hess_th_log_joint(K))
    lap = newton_laplace(lambda th: lj(st.pts, th, w), lambda th: g(st.pts, th, w),
                         lambda th: h(st.pts, th, w), torch.zeros(K * d, device=dev),
                         n_iters=25)
    ths = sample_laplace_from_noise(lap, torch.randn((256, K * d), generator=gen,
                                                      device=dev))
    acc = float(multiclass.compute_accuracy(Xt, yt, ths, K))
    base = float(torch.bincount(yt.long(), minlength=K).max()) / MC_N_TEST
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc} outside [0, 1]")
    total = sum(sel_ms) + sum(opt_ms)
    log(f"multiclass path: {selections} selections, m={m} (fill {m / selections:.2f}), "
        f"{launches} K2 launches, sum(w)={float(w.sum()):.1f}")
    log(f"multiclass build: {total / 1e3:.3f} s (CUDA events), "
        f"{total / selections:.1f} ms per selection: select (K2 over {n} rows) "
        f"{', '.join(f'{x:.2f}' for x in sel_ms)} ms; refinement ({MC_OPT_ITRS} steps, "
        f"Newton refit at K*d={K * d}) {', '.join(f'{x:.1f}' for x in opt_ms)} ms")
    log(f"multiclass test accuracy of the coreset's Laplace posterior: {acc:.4f} "
        f"(majority class {base:.4f}, {MC_N_TEST} held-out rows)")
    return {"launches": launches}


def phase_mc_self_check(seed: int, dev: str = "cuda") -> None:
    """The small full-select multiclass build of
    tests/test_torch_multiclass_build.py (N = 9000 > FUSED_MIN_ROWS, so each
    select goes through K2 on the card and its plain version on the CPU),
    on one set of draws: reference-parity select with a refit every step,
    and dedup select with a refit every 4th step."""
    from betacores_tpu_torch import (IncrementalConfig, flip_labels,
                                     gen_synthetic_multiclass, init_state,
                                     make_incremental_builder, multiclass,
                                     multiclass_laplace_sampler)
    from betacores_tpu_torch.ops import kernels

    N, K, d, S_s, M, itrs = 9000, 3, 4, 32, 10, 5
    gen = torch.Generator().manual_seed(seed)
    _, _, Z = gen_synthetic_multiclass(gen, N, d=d, n_classes=K)
    Z, _ = flip_labels(gen, Z, K, MC_F_RATE)
    make = lambda Z, cfg: make_incremental_builder(Z, multiclass.bundle(K),
                                                   multiclass_laplace_sampler(K), cfg)
    st_at = lambda where: init_state(M, d + 1, beta=MC_BETA, device=where,
                                     sampler_aux=torch.zeros(K * d, device=where))
    for dedup, refit_every in ((False, 1), (True, 4)):
        cfg = IncrementalConfig(projection_dim=S_s, n_subsample_select=None,
                                n_subsample_opt=100, opt_itrs=20, i0=0.5, use_beta=True,
                                dedup_select=dedup, refit_every=refit_every)
        same_build_on_cpu("multiclass self-check", make, Z, st_at, cfg, itrs, gen, dev,
                          kernel=kernels.multiclass_projection)


def shard_operands(gen, dev, n_sub, M_buf, n_live, d, S_loc, packed: bool):
    """Random operands of one K3 launch: those of one fused step
    (``step_operands``, laid out alike) without the Adam state, with
    sc = [beta]."""
    (xin, z, mu, linv, w, _, _, sc, _), _ = step_operands(gen, dev, n_sub, M_buf, n_live,
                                                          d, S_loc, packed)
    return (xin, z, mu, linv, w, sc[:1]), S_loc


def centred_gradient_check(ops, partials, S_loc: int, use_beta: bool, where: str) -> float:
    """The sharded builder's gradient identity on one sample block,
    g = -(a - (r / S) * b) / S from the kernel's partials (assembled in
    float64), against the centred gradient of the plain composition in
    float64, with the reference's target scaling 17.3: within 3e-4 of the
    gradient's largest magnitude (at least 1). The identity cancels the
    uncentred sums, so the float32 rounding of the partials shows in g in
    proportion to its size. Returns max |g - g_centred|."""
    from betacores_tpu_torch.models import logreg
    from betacores_tpu_torch.ops.projection import center

    xin, z, mu, linv, w, sc = (o.double() for o in ops)
    d, M_pad = xin.shape[1] - 1, w.shape[1]
    n_sub_pad, scaling = xin.shape[0] - M_pad, 17.3
    th = z[:S_loc] @ linv + mu
    x, msk = xin[:, :d], xin[:, d:]
    ll = logreg.beta_likelihood(x, th, sc[0]) if use_beta else logreg.log_likelihood(x, th)
    vals = center(ll) * msk
    sub, core = vals[:n_sub_pad], vals[n_sub_pad:]
    g_ref = -(core @ (scaling * sub.sum(dim=0) - w[0] @ core)) / S_loc
    colsum, core_k, corerow, wcore = (o.double() for o in partials)
    r_unc = scaling * colsum - wcore
    a, b = r_unc @ core_k.T, r_unc.sum()
    g = (-(a - (corerow / S_loc) * b) / S_loc)[0]
    err = float((g - g_ref).abs().max())
    log(f"  K3 {where} gradient from the partials vs centred: max|dg| {err:.3e} "
        f"(max|g| {float(g_ref.abs().max()):.3e})")
    if not err <= GRAD_TOL * max(1.0, float(g_ref.abs().max())):
        raise AssertionError(f"K3 {where}: assembled gradient off by {err:.3e}")
    return err


def phase_shard_kernel(seed: int, dev: str = "cuda") -> dict:
    """K3 against its plain version on the card: each output within
    2e-4 * max(1, its largest magnitude), padded rows and columns exactly 0,
    and the gradient assembled from the partials within 3e-4 of the
    centred one (``centred_gradient_check``)."""
    from betacores_tpu_torch.ops import kernels

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    shapes = {"(1, 1) mesh": dict(n_sub=N_OPT, M_buf=M_BUF, n_live=60, d=N_FEAT, S_loc=S,
                                  packed=True),
              "(., 2) mesh": dict(n_sub=N_OPT // 2, M_buf=M_BUF, n_live=60, d=N_FEAT,
                                  S_loc=S // 2, packed=True),
              "ragged": dict(n_sub=37, M_buf=19, n_live=11, d=7, S_loc=45, packed=False)}
    names = ("colsum", "core", "corerow", "wcore")
    err_main, times = 0.0, {}
    for label, shp in shapes.items():
        ops, S_loc = shard_operands(gen, dev, **shp)
        n_live = shp["n_live"]
        for use_beta in (True, False):
            where = (f"[{label}: R={ops[0].shape[0]}, d={shp['d']}, S_loc={S_loc}, "
                     f"s_pad={ops[1].shape[0]}, M_pad={ops[4].shape[1]}, "
                     f"C={kernels.cluster_size(ops[0].shape[0])}, beta={use_beta}]")
            got = kernels.logreg_shard_step_partials(*ops, S_loc, use_beta=use_beta)
            want = kernels.logreg_shard_step_partials_plain(*ops, S_loc, use_beta)
            torch.cuda.synchronize()
            for name, g, w in zip(names, got, want):
                err, scale = float((g - w).abs().max()), float(w.abs().max())
                log(f"  K3 {where} {name}: max|kernel-plain| {err:.3e} (max|plain| {scale:.3e})")
                if g.shape != w.shape or not err <= TOL * max(1.0, scale):
                    raise AssertionError(f"K3 vs plain {where}: {name} off by {err:.3e}")
                if label.startswith("(1, 1)"):
                    err_main = max(err_main, err)
            colsum, core, corerow, wcore = got
            if not (bool((core[:, S_loc:] == 0).all()) and bool((core[n_live:] == 0).all())
                    and bool((corerow[0, n_live:] == 0).all())
                    and bool((colsum[:, S_loc:] == 0).all())
                    and bool((wcore[:, S_loc:] == 0).all())):
                raise AssertionError(f"K3 {where}: padded slots not 0")
            centred_gradient_check(ops, got, S_loc, use_beta, where)
        if label.startswith("(1, 1)"):
            times = step_kernel_times("K3", kernels.logreg_shard_step_partials,
                                      kernels.logreg_shard_step_partials_plain,
                                      kernels.launch_shard_partials,
                                      kernels._shard_lib().logreg_shard_partials_floor, ops,
                                      S_loc, (4,), adam=False)
    return {"max_abs_err": err_main, **times}


def phase_sharded_path(seed: int, n: int, selections: int, dev: str = "cuda") -> dict:
    """The headline build of bench.py through the sharded builder on a
    (1, 1) mesh (what bench.py runs on more than one device), in an NCCL
    group of one rank: every Adam step one Newton refit, one K3 launch and
    two psums; the select three psums and one all_gather."""
    from betacores_tpu_torch import (IncrementalConfig, gen_synthetic_logreg, init_state,
                                     logreg, logreg_laplace_sampler, make_mesh,
                                     make_sharded_incremental_builder, perturb_logreg,
                                     shard_data)
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.parallel import world_of_one

    gen = torch.Generator(device=dev).manual_seed(seed)
    X, y, _ = gen_synthetic_logreg(gen, n, d=N_FEAT)
    X, y, Z, _ = perturb_logreg(gen, X, y, f_rate=0.1)
    del X, y
    cfg = IncrementalConfig(projection_dim=S, n_subsample_select=N_SEL,
                            n_subsample_opt=N_OPT, opt_itrs=OPT_ITRS, i0=1.0,
                            use_beta=True)
    with world_of_one("nccl" if dev == "cuda" else "gloo"):
        mesh = make_mesh(1, 1)
        Zs, n_true = shard_data(Z, mesh)
        del Z
        builder = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                                   logreg_laplace_sampler(), cfg, mesh)
        if builder.route != "fused":
            raise AssertionError(f"sharded refinement took the {builder.route} route")
        draws = builder.generator_draws(seed)
        st0 = init_state(M_BUF, N_FEAT, beta=BETA, device=dev)
        t0 = time.perf_counter()
        builder.build(st0, 1, draws)                     # warm-up selection
        torch.cuda.synchronize()
        log(f"sharded warm-up selection on a {mesh.shape} mesh ({mesh.device}): "
            f"{time.perf_counter() - t0:.2f} s")

        if not builder.graph and dev == "cuda":
            raise AssertionError("the sharded builder does not capture its passes on the card")
        kernels.logreg_shard_step_partials.launches = 0
        kernels.logreg_adam_step.launches = 0
        mesh.calls.clear()
        st, secs, wall = timed_build(builder, st0, selections,
                                     builder.generator_draws(seed + 1))
        launches = kernels.logreg_shard_step_partials.launches
        calls = dict(mesh.calls)
        # the same selections, each step dispatched from Python
        eager = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                                 logreg_laplace_sampler(), cfg, mesh,
                                                 graph=False)
        st_e, secs_e, _ = timed_build(eager, st0, selections, eager.generator_draws(seed + 1))
    want = selections * OPT_ITRS
    if launches != want or kernels.logreg_adam_step.launches != 0:
        raise AssertionError(f"K3 launched {launches} times, want {want}; K1 "
                             f"{kernels.logreg_adam_step.launches}, want 0")
    want_calls = {"psum": selections * (3 + 2 * OPT_ITRS), "all_gather": selections}
    if calls != want_calls:
        raise AssertionError(f"collectives {calls}, want {want_calls}")
    w, m = check_state(st)
    log(f"sharded path: {selections} selections x {OPT_ITRS} steps, m={m} "
        f"(fill {m / selections:.2f}), {launches} K3 launches, 0 K1 launches, "
        f"collectives {calls}, sum(w)={float(w.sum()):.1f}")
    log(f"sharded build, passes captured: {secs:.3f} s (CUDA events), {wall:.3f} s host "
        f"clock, {secs / selections * 1e3:.1f} ms per selection, "
        f"{secs / want * 1e6:.1f} us per Adam step; passes eager: {secs_e:.3f} s, "
        f"{secs_e / want * 1e6:.1f} us per Adam step")
    log(f"sharded path, captured == eager: "
        f"{check_graph_equals_eager('sharded path', st, st_e)}")
    return {"launches": launches}


def phase_sharded_self_check(seed: int, dev: str = "cuda") -> None:
    """The small build of phase 5 on a (1, 1) mesh, three ways under one set
    of draws: the sharded builder through K3 on the card (NCCL), through
    K3's plain version on the CPU (gloo), and the single-device builder
    through K1 on the card. On a (1, 1) mesh the local subsample indices
    are the global ones, so one FixedDraws serves all three."""
    from betacores_tpu_torch import (FixedDraws, IncrementalConfig, init_state, logreg,
                                     logreg_laplace_sampler, make_incremental_builder,
                                     make_mesh, make_sharded_incremental_builder,
                                     shard_data)
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.parallel import world_of_one

    N, D, M, S_s, itrs, T = 1500, 5, 15, 40, 8, 25
    gen = torch.Generator().manual_seed(seed)
    th = torch.randn(D, generator=gen)
    X = torch.randn((N, D), generator=gen)
    y = torch.where(X @ th + 0.3 * torch.randn(N, generator=gen) > 0, 1.0, -1.0)
    Z = y[:, None] * X
    for dedup, refit_every in ((False, 1), (True, 4)):
        cfg = IncrementalConfig(projection_dim=S_s, n_subsample_select=150,
                                n_subsample_opt=150, opt_itrs=T, i0=0.5, use_beta=True,
                                dedup_select=dedup, refit_every=refit_every)
        single = lambda where: make_incremental_builder(
            Z.to(where), logreg.bundle(), logreg_laplace_sampler(), cfg)
        rec = single("cpu").generator_draws(gen)
        st0 = init_state(M, D, beta=0.2, device="cpu")
        draws = FixedDraws([rec.select(i, st0) for i in range(itrs)],
                           [rec.optimize(i, st0) for i in range(itrs)])
        out = {}
        for tag, where, backend in (("K3 on the card", dev, "nccl" if dev == "cuda" else "gloo"),
                                    ("K3 plain on the CPU", "cpu", "gloo")):
            with world_of_one(backend):
                mesh = make_mesh(1, 1, device=where)
                Zs, n_true = shard_data(Z, mesh)
                b = make_sharded_incremental_builder(Zs, n_true, logreg.bundle(),
                                                     logreg_laplace_sampler(), cfg, mesh)
                before = kernels.logreg_shard_step_partials.launches
                st = b.build(init_state(M, D, beta=0.2, device=where), itrs, draws)
                out[tag] = (st, kernels.logreg_shard_step_partials.launches - before)
        before = kernels.logreg_adam_step.launches
        st = single(dev).build(init_state(M, D, beta=0.2, device=dev), itrs, draws)
        out["K1 single-device on the card"] = (st, kernels.logreg_adam_step.launches - before)
        mode = f"dedup_select={dedup}, refit_every={refit_every}"
        if dev != "cpu":
            for tag in ("K3 on the card", "K1 single-device on the card"):
                if out[tag][1] != itrs * T:
                    raise AssertionError(f"sharded self-check ({mode}): {tag} launched its "
                                         f"kernel {out[tag][1]} times, want {itrs * T}")
        ref_tag = "K3 plain on the CPU"
        for tag in ("K3 on the card", "K1 single-device on the card"):
            summary = check_same_build(f"sharded self-check [{mode}]: {tag}", out[tag][0],
                                       out[ref_tag][0])
            log(f"sharded self-check [{mode}]: {tag} == {ref_tag} ({summary})")


def phase_bench(seed: int, n: int, selections: int = 3, dev: str = "cuda") -> None:
    """The port's headline entry point, driven as its ``main`` drives it."""
    import bench_torch

    from betacores_tpu_torch.ops import kernels

    kernels.logreg_adam_step.launches = 0
    rec = bench_torch.run(n=n, selections=selections, device=dev, seed=seed)
    launches = kernels.logreg_adam_step.launches
    log(f"bench_torch.run: {json.dumps(rec)}; logreg_adam_step launches {launches}")
    # the warm-up and the timed build, then three passes timed alone
    want = (2 * selections + 3) * OPT_ITRS
    if dev == "cuda" and launches != want:
        raise AssertionError(f"bench_torch.run launched K1 {launches} times, expected {want}")
    if set(rec) != {"metric", "value", "unit", "selected", "budget", "fill"}:
        raise AssertionError(f"bench_torch.run: unexpected record {rec}")
    if not rec["value"] > 0 or rec["budget"] != selections or not 0 < rec["fill"] <= 1:
        raise AssertionError(f"bench_torch.run: bad record {rec}")


def laplace_thetas(w, p, d: int, gen, n: int = 256, log_joint=None, grad=None,
                   hess=None):
    """``n`` draws of a coreset's Laplace posterior (25 Newton iterations
    from 0), by default the logistic one's."""
    from betacores_tpu_torch.inference import newton_laplace, sample_laplace_from_noise
    from betacores_tpu_torch.models import logreg

    lj = log_joint or logreg.log_joint
    g = grad or logreg.grad_th_log_joint
    h = hess or logreg.hess_th_log_joint
    w = torch.as_tensor(w, device=gen.device)
    p = torch.as_tensor(p, device=gen.device)
    lap = newton_laplace(lambda th: lj(p, th, w), lambda th: g(p, th, w),
                         lambda th: h(p, th, w), torch.zeros(d, dtype=w.dtype, device=gen.device),
                         n_iters=25)
    return sample_laplace_from_noise(lap, torch.randn((n, d), generator=gen, dtype=w.dtype,
                                                      device=gen.device))


def static_buffer_storages(builder) -> set:
    """The storage addresses of every static buffer of a builder's passes."""
    out = set()
    for p in (builder._fused, builder._composed):
        for t in ([] if p is None else vars(p).values()):
            for x in (t if isinstance(t, tuple) else (t,)):
                if isinstance(x, torch.Tensor):
                    out.add(x.untyped_storage().data_ptr())
    return out


def phase_api(seed: int, n: int, selections: int, dev: str = "cuda") -> dict:
    """The object API at the headline's full width (the module docstring's
    phase 12). Returns the launches of K1 and K2 in the API's driven runs
    (counted from 0 before each run and read after it; the comparison
    build of the functional builder is not counted)."""
    import copy

    import betacores_tpu_torch as bc
    from betacores_tpu_torch import (flip_labels, gen_synthetic_logreg,
                                     gen_synthetic_multiclass, logreg, logreg_laplace_sampler,
                                     make_incremental_builder, multiclass,
                                     multiclass_laplace_sampler, perturb_logreg)
    from betacores_tpu_torch.evaluation import compute_accuracy
    from betacores_tpu_torch.ops import kernels

    k1, k2 = kernels.logreg_adam_step, kernels.multiclass_projection
    counts = {"K1": 0, "K2": 0}

    def driven(what: str, fn, sels: int = 0, itrs: int = OPT_ITRS, k1_want=None,
               k2_want=None):
        """Runs ``fn`` (``sels`` selections of ``itrs`` Adam steps each) with
        both counts from 0, adds its launches to the phase's, checks them,
        and returns (fn's value, seconds by CUDA events)."""
        k1.launches = k2.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        secs = start.elapsed_time(end) / 1e3
        got = {"K1": k1.launches, "K2": k2.launches}
        counts["K1"] += got["K1"]
        counts["K2"] += got["K2"]
        for name, want in (("K1", k1_want), ("K2", k2_want)):
            if want is not None and dev == "cuda" and got[name] != want:
                raise AssertionError(f"{what}: {name} launched {got[name]} times, want {want}")
        per = (f", {secs / sels:.3f} s per selection, {secs / (sels * itrs) * 1e6:.1f} us "
               f"per Adam step (selects included)" if sels else "")
        log(f"api {what}: {secs:.3f} s (CUDA events){per}; launches {got}")
        return out, secs

    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    X, y, _ = gen_synthetic_logreg(gen, n + N_TEST, d=N_FEAT)
    Xt, yt = X[n:], y[n:]
    _, _, Z, out = perturb_logreg(gen, X[:n], y[:n], f_rate=0.1)
    del X, y
    log(f"api data: N={n} x d={N_FEAT} on {Z.device}, {len(out)} corrupted rows, "
        f"{N_TEST} clean held-out rows")
    common = dict(n_subsample_select=N_SEL, n_subsample_opt=N_OPT, opt_itrs=OPT_ITRS,
                  step_sched=lambda i: 1.0 / (1.0 + i), seed=seed, max_size=M_BUF,
                  device=dev)
    sampler, model = logreg_laplace_sampler(), logreg.bundle()
    prj_b = bc.BetaBlackBoxProjector(sampler, S, model=model)
    prj_w = bc.BlackBoxProjector(sampler, S, model=model)
    acc = {}

    def accuracy(tag, alg):
        w, p = alg.get()[:2]
        acc[f"{tag} ({len(w)} points)"] = float(
            compute_accuracy(Xt, yt, laplace_thetas(w, p, N_FEAT, gen)))

    # BCORES: a warm-up selection, then build_trace, against the functional
    # builder from the same state under the same generator
    bcores = bc.BetaCoreset(Z, prj_b, beta=BETA, **common)
    driven("BCORES warm-up build(1, 1)", lambda: bcores.build(1, 1), 1, k1_want=OPT_ITRS)
    st1, keys = bcores.state, copy.deepcopy(bcores.keys)
    trace, _ = driven(f"BCORES build_trace({selections})",
                      lambda: bcores.build_trace(selections), selections,
                      k1_want=selections * OPT_ITRS)
    log(f"api BCORES: m={int(bcores.state.m)}, {len(trace)} snapshots, the last of "
        f"{len(trace[-1][0])} points")
    fb = make_incremental_builder(Z, model, sampler, bcores._cfg,
                                  step_sizes=bcores._builder.step_sizes)
    st_f = fb.build(st1, selections, fb.generator_draws(keys()))
    log(f"api BCORES == the functional build: "
        f"{check_graph_equals_eager('api BCORES vs functional', bcores.state, st_f)}")
    check_state(bcores.state)

    # optimize() with its rollback guard; the state it keeps is its own
    e0 = bcores.error()
    before = bcores.state
    driven("BCORES optimize()", bcores.optimize, k1_want=OPT_ITRS)
    e1 = bcores.error()
    kept = bcores.state
    log(f"api BCORES optimize(): error {e0:.6g} -> {e1:.6g}, "
        f"{'rolled back' if kept is before else 'kept'}, "
        f"reached_numeric_limit={bcores.reached_numeric_limit}")
    shared = {t.untyped_storage().data_ptr() for t in kept} & static_buffer_storages(
        bcores._builder)
    if shared:
        raise AssertionError("optimize() kept a state that aliases the builder's buffers")
    snap = [t.clone() for t in kept]
    accuracy("BCORES", bcores)
    m_b = len(bcores.get()[0])
    bcores.build(1, int(bcores.state.m) + 1)        # replays over the same buffers
    if not all(torch.equal(a, b) for a, b in zip(kept, snap)):
        raise AssertionError("a later pass overwrote the state optimize() kept")

    # SVI: K1's ll variant
    svi = bc.SparseVICoreset(Z, prj_w, **common)
    driven("SVI warm-up build(1, 1)", lambda: svi.build(1, 1), 1, k1_want=OPT_ITRS)
    driven("SVI build(3, 4)", lambda: svi.build(3, 4), 3, k1_want=3 * OPT_ITRS)
    log(f"api SVI: m={int(svi.state.m)}")
    check_state(svi.state)
    accuracy("SVI", svi)

    # learn_beta: captured, then eager from the same seed; never K1. The
    # first forward-mode derivative in a process loads torch's Python
    # dispatch machinery (seconds of host time), so it is taken, and
    # timed, before the builds
    t0 = time.perf_counter()
    model.beta_gradient(Z[:8], Z[:4], torch.tensor(BETA, device=dev))
    torch.cuda.synchronize()
    log(f"api learn_beta: the process's first forward-mode derivative took "
        f"{time.perf_counter() - t0:.2f} s (host clock)")
    lb = {}
    for mode, graph in (("captured", None), ("eager", False)):
        alg = bc.BetaCoreset(Z, prj_b, beta=BETA, learn_beta=True, graph=graph, **common)
        driven(f"learn_beta {mode} build(2, 2)", lambda: alg.build(2, 2), 2, k1_want=0)
        lb[mode] = alg
    beta = float(lb["captured"].state.beta)
    log(f"api learn_beta: captured == eager: "
        f"{check_graph_equals_eager('api learn_beta', lb['captured'].state, lb['eager'].state)}"
        f"; beta {BETA} -> {beta:.6g} (eager {float(lb['eager'].state.beta):.6g})")
    if not 1e-3 <= beta <= 1.0 or beta == BETA:
        raise AssertionError(f"learn_beta: beta {beta} did not move within [1e-3, 1]")
    if abs(beta - float(lb["eager"].state.beta)) > GRAPH_TOL * beta:
        raise AssertionError("learn_beta: captured and eager beta differ")

    # the diagonal Laplace sampler through K1, across a buffer growth
    prj_d = bc.BetaBlackBoxProjector(logreg_laplace_sampler(diag=True), S, model=model)
    idx0 = torch.arange(63, device=dev)
    diag = bc.BetaCoreset(Z, prj_d, beta=BETA, wts=torch.ones(63).numpy(),
                          idcs=idx0.cpu().numpy(), pts=Z[idx0].cpu().numpy(),
                          **dict(common, max_size=0))
    driven("diag build(1, 64) at 64 slots", lambda: diag.build(1, 64), 1, k1_want=OPT_ITRS)
    mem0 = torch.cuda.memory_allocated()
    driven("diag build(1, 65), grown to 128 slots", lambda: diag.build(1, 65), 1,
           k1_want=OPT_ITRS)
    if diag.state.wts.shape[0] != 128 or diag._builder._fused.M_buf != 128:
        raise AssertionError("the diag coreset's buffer did not grow to 128 slots")
    log(f"api diag: memory allocated {mem0 / 2**20:.1f} -> "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB across the growth "
        f"(peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB)")
    check_state(diag.state)

    # RAND: 100 uniform draws
    rand = bc.UniformSamplingCoreset(Z, seed=seed, device=dev)
    driven("RAND build(100, 100)", lambda: rand.build(100, 100), k1_want=0, k2_want=0)
    w, _, _ = rand.get()
    if abs(float(w.sum()) - n) > 1e-3 * n:
        raise AssertionError(f"RAND weights sum to {float(w.sum())}, want {n}")
    accuracy("RAND", rand)
    rand_m = bc.UniformSamplingCoreset(Z, seed=seed, device=dev)   # at BCORES's size
    rand_m.build(m_b, m_b)
    accuracy("RAND", rand_m)
    log(f"api test accuracy of the Laplace posterior ({N_TEST} clean held-out rows): "
        + ", ".join(f"{k} {v:.4f}" for k, v in acc.items()))
    for k, v in acc.items():
        if not 0.0 <= v <= 1.0:
            raise AssertionError(f"{k} accuracy {v} outside [0, 1]")
    del Z, Xt, yt, bcores, svi, lb, diag, fb, st_f, st1, kept, snap, before
    torch.cuda.empty_cache()

    # multiclass: full-candidate select, K2 once per select
    K, d = MC_K, MC_D
    Xm, ym, Zm = gen_synthetic_multiclass(gen, MC_ROWS + MC_N_TEST, d=d, n_classes=K)
    Zc, _ = flip_labels(gen, Zm[:MC_ROWS], K, MC_F_RATE)
    prj_m = bc.BetaBlackBoxProjector(multiclass_laplace_sampler(K), S,
                                     model=multiclass.bundle(K), theta_dim=K * d)
    mc = bc.BetaCoreset(Zc, prj_m, beta=MC_BETA, n_subsample_select=None,
                        n_subsample_opt=MC_N_OPT, opt_itrs=MC_OPT_ITRS,
                        step_sched=lambda i: 1.0 / (1.0 + i), seed=seed, max_size=MC_M,
                        device=dev)
    driven("multiclass build(2, 2)", lambda: mc.build(2, 2), 2, MC_OPT_ITRS, k1_want=0,
           k2_want=2)
    check_state(mc.state)
    w, p = (torch.as_tensor(a, device=dev) for a in mc.get()[:2])
    ths = laplace_thetas(w, p, K * d, gen, log_joint=multiclass.make_log_joint(K),
                         grad=multiclass.make_grad_th_log_joint(K),
                         hess=multiclass.make_hess_th_log_joint(K))
    mc_acc = float(multiclass.compute_accuracy(Xm[MC_ROWS:], ym[MC_ROWS:], ths, K))
    log(f"api multiclass: m={int(mc.state.m)}, test accuracy {mc_acc:.4f}")
    return counts


def family_run(tag: str, alg, selections: int, card: str) -> tuple:
    """Drives one object-API coreset of phase 13 on the card: a warm-up
    selection (its pass runs each kind of step eagerly once, then captures
    it), one selection captured and the same selection again with
    ``graph=False`` from the same state and draws (which must agree as
    phase 4's builds do), ``selections - 1`` more captured, then one
    select and one captured refinement pass alone. Prints s per selection,
    us per captured and eager step, ms per select and the fill; returns the
    two step times in us."""
    import copy

    from betacores_tpu_torch import make_incremental_builder

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3

    b = alg._builder
    T = b.step_sizes.shape[0]
    _, warm = timed(lambda: alg.build(1, 1))
    st1, keys = alg.state, copy.deepcopy(alg.keys)
    _, first = timed(lambda: alg.build(1, 2))
    eb = make_incremental_builder(alg.data, b.model, b.sampler, b.config,
                                  step_sizes=b.step_sizes, graph=False)
    st_e, eager = timed(lambda: eb.build(st1, 1, eb.generator_draws(keys())))
    agree = check_graph_equals_eager(tag, alg.state, st_e)
    _, rest = timed(lambda: alg.build(selections - 1, selections + 1))
    draws = b.generator_draws(torch.Generator(device=alg.device).manual_seed(selections))
    st_s, sel = timed(lambda: b.select(alg.state, draws))
    _, opt = timed(lambda: b.optimize(st_s, draws))
    w, m = check_state(alg.state)
    log(f"{tag}: {selections} selections captured, {(first + rest) / selections:.3f} s per "
        f"selection (warm-up {warm:.3f} s, eager {eager:.3f} s); per Adam step "
        f"{opt / T * 1e6:.1f} us captured (a pass alone), "
        f"{(eager - sel) / T * 1e6:.1f} us eager; select {sel * 1e3:.2f} ms; m={m} of "
        f"{selections + 1} selections (fill {m / (selections + 1):.2f}), "
        f"{int((w > 0).sum())} points of positive weight; {card}")
    log(f"{tag}, captured == eager: {agree}")
    return opt / T * 1e6, (eager - sel) / T * 1e6


def phase_families(seed: int, card: str, n: int = FAM_ROWS, selections: int = FAM_SELECTIONS,
                   dev: str = "cuda") -> str:
    """Phase 13: the known-covariance Gaussian, Poisson, unknown-covariance
    Gaussian and linear-regression families through the object API, each at
    its reference example's widths over n rows made on the card from
    ``seed``, with no kernel of this repo on their path (the reference
    computes their projections as plain XLA); the K1, K2 and K3 launches
    of the phase must all be 0. Returns one short line of the captured and
    eager us a step per family and the Gaussian reverse KLs."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.evaluation import regression_rmse_nll, reverse_forward_kl
    from betacores_tpu_torch.models import gaussian, linreg, mvn, poisson
    from betacores_tpu_torch.ops import kernels

    wrappers = (kernels.logreg_adam_step, kernels.multiclass_projection,
                kernels.logreg_shard_step_partials)
    for k in wrappers:
        k.launches = 0
    t_phase = time.perf_counter()
    # on the card the classes take their default device, the card
    on = {} if dev == "cuda" else {"device": dev}
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    f64 = torch.float64
    eye = lambda d, dt=torch.float32: torch.eye(d, dtype=dt, device=dev)

    # the contaminated Gaussian of examples/zellner_gaussian.py
    d = G_D
    X, Xc, Sig = bc.gen_synthetic_gaussian(gen, N=n, d=d)
    Siginv, logdet = torch.linalg.inv(Sig), float(torch.linalg.slogdet(Sig)[1])
    mu0 = torch.zeros(d, device=dev)
    model, smp = gaussian.bundle(Siginv, logdet), bc.gaussian_conjugate_sampler(mu0, eye(d), Siginv)
    prior64 = (mu0.double(), eye(d, f64), Siginv.double())
    post_full = gaussian.weighted_post(*prior64, X.double(), torch.ones(n, dtype=f64, device=dev))
    del X
    log(f"families, Gaussian data: N={n} clean + {Xc.shape[0] - n} outlier rows x d={d} "
        f"on {Xc.device} ({Xc.numel() * 4 / 1e6:.0f} MB)")
    common = dict(n_subsample_select=G_N_SEL, n_subsample_opt=G_N_OPT, opt_itrs=G_ITRS,
                  step_sched=lambda i: G_I0 / (1.0 + i), seed=seed, max_size=G_M, **on)
    kl, us = {}, {}
    for tag, alg in (("BCORES", bc.BetaCoreset(Xc, bc.BetaBlackBoxProjector(smp, G_S, model=model),
                                               beta=G_BETA, **common)),
                     ("SVI", bc.SparseVICoreset(Xc, bc.BlackBoxProjector(smp, G_S, model=model),
                                                **common))):
        us[f"Gaussian {tag}"] = family_run(f"families, Gaussian {tag}", alg, selections, card)
        w, p = (torch.as_tensor(a, device=dev) for a in alg.get()[:2])
        kl[tag] = reverse_forward_kl(gaussian.weighted_post(*prior64, p.double(), w.double()),
                                     post_full)
    kl["prior"] = reverse_forward_kl(gaussian.weighted_post(
        *prior64, torch.zeros((1, d), dtype=f64, device=dev),
        torch.zeros(1, dtype=f64, device=dev)), post_full)
    log("families, Gaussian reverse / forward KL to the clean-data posterior: " + ", ".join(
        f"{k} {float(r):.6g} / {float(f):.6g}" for k, (r, f) in kl.items()))
    if not all(bool(torch.isfinite(torch.stack(v)).all()) for v in kl.values()):
        raise AssertionError("a Gaussian KL is not finite")
    if not float(kl["BCORES"][0]) < float(kl["SVI"][0]):
        raise AssertionError("the BCORES coreset's reverse KL is not below SVI's")
    del Xc, post_full
    torch.cuda.empty_cache()

    # BCORES at the example's own N: there the example's i0 moves the weights
    # far enough within G_EXAMPLE_SELECTIONS for a coreset that does nothing
    # (the prior) to fail
    t0 = time.perf_counter()
    X, Xc, _ = bc.gen_synthetic_gaussian(gen, N=G_EXAMPLE_N, d=d)
    post_n = gaussian.weighted_post(*prior64, X.double(),
                                    torch.ones(G_EXAMPLE_N, dtype=f64, device=dev))
    alg = bc.BetaCoreset(Xc, bc.BetaBlackBoxProjector(smp, G_S, model=model), beta=G_BETA,
                         **common)
    alg.build(G_EXAMPLE_SELECTIONS, G_EXAMPLE_SELECTIONS)
    w, p, idx = (torch.as_tensor(a, device=dev) for a in alg.get()[:3])
    r_b = float(reverse_forward_kl(gaussian.weighted_post(*prior64, p.double(), w.double()),
                                   post_n)[0])
    r_0 = float(reverse_forward_kl(gaussian.weighted_post(
        *prior64, torch.zeros((1, d), dtype=f64, device=dev),
        torch.zeros(1, dtype=f64, device=dev)), post_n)[0])
    n_out = int((idx >= G_EXAMPLE_N).sum())
    log(f"families, Gaussian BCORES at the example's N={G_EXAMPLE_N} (+{Xc.shape[0] - G_EXAMPLE_N} "
        f"outlier rows), {G_EXAMPLE_SELECTIONS} selections captured, "
        f"{time.perf_counter() - t0:.2f} s with the data (host clock): reverse KL {r_b:.6g} against the prior's {r_0:.6g} "
        f"({100 * (1 - r_b / r_0):.2f} % below, the check asks {100 * G_GAIN:g} %), total "
        f"weight {float(w.sum()):.6g} on {len(w)} points, {n_out} of them outlier rows; {card}")
    if not r_b <= (1.0 - G_GAIN) * r_0:
        raise AssertionError(f"BCORES at N={G_EXAMPLE_N}: reverse KL {r_b:.6g} is not "
                             f"{100 * G_GAIN:g} % below the prior's {r_0:.6g}")
    if n_out:
        raise AssertionError(f"BCORES at N={G_EXAMPLE_N} took in {n_out} outlier rows")
    del X, Xc, post_n, alg

    # Poisson regression, examples/poisson_regression.py on synthetic counts
    d = P_D
    X, y, _, th = bc.gen_synthetic_poisson(gen, N=n, d=d)
    bad = torch.randperm(n, generator=gen, device=dev)[:int(P_F_RATE * n)]
    y = y.clone()
    y[bad] += P_SHIFT
    Z = torch.cat([X, y[:, None]], dim=1)
    y_max = float(y.max())
    model = poisson.bundle(gaussian_mass=y_max > 30.0, k_max=int(min(y_max * 2 + 20, 128)))
    log(f"families, Poisson data: N={n} x d={d}, {len(bad)} counts shifted by +{P_SHIFT:g}, "
        f"max count {y_max:g} (gaussian_mass={y_max > 30.0}, "
        f"k_max={int(min(y_max * 2 + 20, 128))})")
    prj = bc.BetaBlackBoxProjector(bc.poisson_laplace_sampler(), P_S, theta_dim=d, model=model)
    for refit_every in (1, 4):
        alg = bc.BetaCoreset(Z, prj, beta=P_BETA, n_subsample_select=P_N_SEL,
                             n_subsample_opt=P_N_OPT, opt_itrs=P_ITRS,
                             step_sched=lambda i: P_I0 / (1.0 + i), seed=seed,
                             max_size=P_M, refit_every=refit_every, **on)
        us[f"Poisson refit {refit_every}"] = family_run(
            f"families, Poisson refit_every={refit_every}", alg, selections, card)
    # the exact mass term at 2^20 rows x 100 samples x k_max = 64, in row chunks
    thetas = th + 0.3 * torch.randn((100, d), generator=gen, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got = poisson.beta_likelihood(Z, thetas, P_BETA, k_max=64)
    end.record()
    end.synchronize()
    want = poisson.beta_likelihood(Z[:2048].double(), thetas.double(), P_BETA, k_max=64)
    err = float((got[:2048].double() - want).abs().max())
    tol = 1e-4 * float(want.abs().max())
    if got.shape != (n, 100) or not bool(torch.isfinite(got).all()) or not err <= tol:
        raise AssertionError(f"the exact Poisson mass over {n} rows: shape {tuple(got.shape)}, "
                             f"error {err:.3e} against float64 (tolerance {tol:.3e})")
    log(f"families, Poisson exact-mass beta-likelihood ({n} x 100 x 65, "
        f"{poisson.MASS_CHUNK_ELEMENTS} elements a chunk): {start.elapsed_time(end):.2f} ms "
        f"(CUDA events), max |error| on 2048 rows against float64 {err:.3e}; {card}")
    del X, y, Z, got
    torch.cuda.empty_cache()

    # the unknown-covariance Gaussian of examples/mvn_unknown_cov.py
    d = V_D
    A = 0.3 * torch.randn((d, d), generator=gen, device=dev)
    L_true = torch.linalg.cholesky(A @ A.T + eye(d))
    X = 2.0 + torch.randn((n, d), generator=gen, device=dev) @ L_true.T
    Xout = V_SHIFT + 0.5 * torch.randn((int(V_F_RATE * n), d), generator=gen, device=dev)
    Xc = torch.cat([X, Xout])
    prior = (torch.zeros(d, device=dev), 1.0, 2.0 * eye(d), d + 4.0)
    prj = bc.BetaBlackBoxProjector(mvn.mvn_niw_sampler(*prior), V_S, theta_dim=d + d * d,
                                   model=mvn.bundle(d))
    alg = bc.BetaCoreset(Xc, prj, beta=V_BETA, n_subsample_select=V_N_SEL,
                         n_subsample_opt=V_N_OPT, opt_itrs=V_ITRS,
                         step_sched=lambda i: V_I0 / (1.0 + i), seed=seed, max_size=V_M,
                         **on)
    if not alg._builder.per_step:
        raise AssertionError("the NIW sampler did not take the per-step-draw route")
    us["MVN"] = family_run("families, MVN (NIW, per-step draws)", alg, selections, card)
    w, p = (torch.as_tensor(a, device=dev, dtype=f64) for a in alg.get()[:2])
    prior64 = (prior[0].double(), 1.0, prior[2].double(), float(prior[3]))
    post = lambda pts, wts: mvn.weighted_post(*prior64, pts, wts)
    clean = post(X.double(), torch.ones(n, dtype=f64, device=dev))
    kls = {"BCORES": mvn.niw_kl(post(p, w), clean),
           "all rows": mvn.niw_kl(post(Xc.double(), torch.ones(len(Xc), dtype=f64, device=dev)),
                                  clean)}
    log("families, MVN KL(NIW || clean-data NIW): " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in kls.items()))
    if not all(bool(torch.isfinite(v)) for v in kls.values()):
        raise AssertionError("an MVN KL is not finite")
    del X, Xout, Xc
    torch.cuda.empty_cache()

    # linear regression with examples/zellner_neural_linear.py's widths
    X, y, _ = bc.gen_synthetic_linreg(gen, N=n + N_TEST, D=L_D)
    Z, Xt, yt = torch.cat([X[:n], y[:n]], dim=1), X[n:], y[n:]
    mean, std = float(y[:n].mean()), float(y[:n].std())
    sigsq = max(std ** 2, 1e-3)
    F = X.shape[1]
    mu0, Sig0inv = mean * torch.ones(F, device=dev), eye(F) / (std ** 2 + mean ** 2)
    prj = bc.BetaBlackBoxProjector(bc.linreg_conjugate_sampler(mu0, Sig0inv, sigsq), L_S,
                                   model=linreg.bundle(sigsq), theta_dim=F)
    alg = bc.BetaCoreset(Z, prj, beta=L_BETA, n_subsample_select=L_N_SEL,
                         n_subsample_opt=L_N_OPT, opt_itrs=L_ITRS,
                         step_sched=lambda i: L_I0 / (1.0 + i), seed=seed, max_size=L_M,
                         **on)
    us["linreg"] = family_run("families, linear regression", alg, selections, card)
    w, p = (torch.as_tensor(a, device=dev) for a in alg.get()[:2])
    scores = {}
    for tag, (pts, wts) in (("BCORES", (p, w)), ("all rows", (Z, torch.ones(n, device=dev)))):
        post = linreg.weighted_post(mu0, Sig0inv, sigsq, pts, wts)
        ths = gaussian.sample_gaussian_prec(gen, post, 100)
        scores[tag] = [float(v) for v in regression_rmse_nll(Xt, yt, ths, sigsq)]
    log(f"families, linear regression on {N_TEST} held-out rows (sigsq {sigsq:.6g}): " + ", ".join(
        f"{k} RMSE {r:.6g}, NLL {v:.6g}" for k, (r, v) in scores.items()))
    if not all(np.isfinite(v).all() for v in scores.values()):
        raise AssertionError("a linear-regression score is not finite")
    del X, y, Z, Xt, yt
    torch.cuda.empty_cache()
    counts = {k.__name__: k.launches for k in wrappers}
    if any(counts.values()):
        raise AssertionError(f"phase 13 launched a kernel: {counts}")
    log(f"families: phase 13 in {time.perf_counter() - t_phase:.1f} s; kernel launches {counts} "
        f"(none of the repo's kernels is on these families' path)")
    return ("families, us a step captured/eager: " + ", ".join(
        f"{k} {c:.1f}/{e:.1f}" for k, (c, e) in us.items())
        + "; Gaussian reverse KL BCORES/SVI/prior " + "/".join(
            f"{float(kl[k][0]):.6g}" for k in ("BCORES", "SVI", "prior"))
        + f", at the example's N BCORES/prior {r_b:.6g}/{r_0:.6g}")


def _synced(fn):
    """(fn(), seconds of host clock), the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _first_departure(got, want):
    """The first iteration (from 1) after which two (itrs, N) traces hold
    different columns, or None."""
    diff = ((got > 0) != (want > 0)).any(dim=1)
    return int(torch.nonzero(diff)[0, 0]) + 1 if bool(diff.any()) else None


def phase_hilbert(seed: int, card: str, n: int = FAM_ROWS, dev: str = "cuda") -> dict:
    """Phase 14: the Hilbert slice (snnls/, HilbertCoreset, refine() and the
    sharded Hilbert build) at full width, in float32 on data made on the card
    from ``seed``. Returns K2's launches in the phase and one summary line."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch import snnls
    from betacores_tpu_torch.evaluation import reverse_forward_kl
    from betacores_tpu_torch.models import gaussian, multiclass
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.ops.projection import project_beta
    from betacores_tpu_torch.parallel import (ShardedHilbertCoreset, make_mesh, shard_data,
                                              world_of_one)

    t_phase = time.perf_counter()
    on = {} if dev == "cuda" else {"device": dev}
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    f64 = torch.float64
    eye = lambda d, dt=torch.float32: torch.eye(d, dtype=dt, device=dev)
    k2 = kernels.multiclass_projection
    k2_total, summary = 0, []

    def gaussian_setup(N):
        """examples/zellner_gaussian.py's data over N clean rows, its model,
        the clean and the contaminated posteriors (float64) and its two
        Hilbert projectors: GIGAO's (the clean posterior) and GIGAR's
        (mis-tuned, the example's lines 86-95)."""
        d = G_D
        X, Xc, Sig = bc.gen_synthetic_gaussian(gen, N=N, d=d)
        Siginv, logdet = torch.linalg.inv(Sig), float(torch.linalg.slogdet(Sig)[1])
        prior64 = (torch.zeros(d, dtype=f64, device=dev), eye(d, f64), Siginv.double())
        ones = lambda m: torch.ones(m, dtype=f64, device=dev)
        post = gaussian.weighted_post(*prior64, X.double(), ones(N))
        post_c = gaussian.weighted_post(*prior64, Xc.double(), ones(Xc.shape[0]))
        mu, cov = post.mu.float(), post.cov.float()
        U = float(torch.rand((), generator=gen, device=dev))
        muhat = U * mu
        muhat = muhat + H_PIHAT * torch.linalg.norm(muhat) * torch.randn(
            (d,), generator=gen, device=dev)
        Sighat = (U * cov + (1.0 - U) * eye(d)) * math.exp(
            -2 * H_PIHAT * abs(float(torch.randn((), generator=gen, device=dev))))
        model = gaussian.bundle(Siginv, logdet)
        prj = {"GIGAO": bc.BlackBoxProjector(bc.prior_gaussian_sampler(
                   mu, torch.linalg.cholesky(cov)), G_S, model=model),
               "GIGAR": bc.BlackBoxProjector(bc.prior_gaussian_sampler(
                   muhat, torch.linalg.cholesky(Sighat)), G_S, model=model)}
        return X, Xc, model, prior64, post, post_c, prj

    def rkl(w, p, prior64, post):
        return float(reverse_forward_kl(gaussian.weighted_post(
            *prior64, torch.as_tensor(p, device=dev).double().reshape(-1, G_D),
            torch.as_tensor(w, device=dev).double()), post)[0])

    # --- the Gaussian Hilbert coresets at the example's widths, N = 2^20 ---
    X, Xc, model, prior64, post, post_c, prj = gaussian_setup(n)
    kl0 = {k: rkl(torch.zeros(1), torch.zeros((1, G_D)), prior64, p)
           for k, p in (("clean", post), ("contaminated", post_c))}
    log(f"hilbert, Gaussian data: N={n} clean + {Xc.shape[0] - n} outlier rows x d={G_D}, "
        f"S={G_S}, M={G_M}; the prior's reverse KL to the clean / contaminated posterior "
        f"{kl0['clean']:.6g} / {kl0['contaminated']:.6g}")
    for tag in ("GIGAO", "GIGAR"):
        alg, t_proj = _synced(lambda: bc.HilbertCoreset(Xc, prj[tag], seed=seed, **on))
        W, t_tr = _synced(lambda: alg.snnls.build_trace(G_M))
        A, b = alg.snnls.A, alg.snnls.b
        err = torch.stack([torch.linalg.norm(A @ W[m] - b) for m in range(G_M)])
        rises = int((err[1:] > err[:-1] * (1 + 1e-6)).sum())
        alg._sync_state()                     # the example's route (:198-206)
        w, p, _ = alg.get()
        kl = {k: rkl(w, p, prior64, q) for k, q in (("clean", post), ("contaminated", post_c))}
        log(f"hilbert, {tag}: projection of {Xc.shape[0]} rows {t_proj:.3f} s; GIGA "
            f"build_trace({G_M}) {t_tr:.3f} s, {t_tr / G_M * 1e3:.3f} ms per greedy "
            f"iteration (host clock); error {float(err[0]):.6g} -> {float(err[-1]):.6g}, "
            f"{rises} rises; {len(w)} points, reverse KL to the clean / contaminated "
            f"posterior {kl['clean']:.6g} / {kl['contaminated']:.6g}; {card}")
        # GIGA's own objective: it never rises, and ends below the empty
        # coreset's ||b||. (Its posterior is far from both posteriors at these
        # widths, as the JAX package's GIGA under the same samples: the KLs
        # are printed, not checked.)
        if rises or not bool(torch.isfinite(err).all()) or not err[-1] < torch.linalg.norm(b):
            raise AssertionError(f"{tag}: the error rose along the trace ({rises} times) or "
                                 f"ended at {float(err[-1]):.6g}, not below ||b||")
        summary.append(f"{tag} {t_tr / G_M * 1e3:.3f} ms/it")
        if tag == "GIGAO":
            # a trace row is the weights of a build of that many iterations
            again = bc.HilbertCoreset(Xc, prj[tag], seed=seed, **on)
            _, t_b = _synced(lambda: again.snnls.build(H_ROW))
            wb = again.snnls.w
            scale = float(wb.abs().max())
            if not (torch.equal(wb > 0, W[H_ROW - 1] > 0)
                    and float((wb - W[H_ROW - 1]).abs().max()) <= GRAPH_TOL * scale):
                raise AssertionError(f"trace row {H_ROW - 1} is not build({H_ROW})'s weights")
            log(f"hilbert, {tag}: build({H_ROW}) {t_b:.3f} s equals trace row {H_ROW - 1}")
            del again
            # the greedy loop reads nothing on the host
            pre = snnls.giga_precompute(A, b)
            step = lambda w: snnls.giga_step(pre, w, 1e-12)
            error = lambda w: torch.linalg.norm(A @ w - b)
            w0 = torch.zeros(A.shape[1], device=dev)
            torch.cuda.synchronize()
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                st = snnls.build(step, error, w0, G_M)
                t_loop = time.perf_counter() - t0
            finally:
                if dev == "cuda":
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            if not torch.equal(st.w, W[G_M - 1]):
                raise AssertionError("the sync-debug build differs from the trace")
            log(f"hilbert, GIGA build({G_M}) under set_sync_debug_mode('error'): no host read "
                f"in the loop; {t_loop:.3f} s to enqueue, {t_run:.3f} s to finish "
                f"({t_run / G_M * 1e3:.3f} ms per greedy iteration), equal to the trace")
            del pre
        del alg, W, A, b
    torch.cuda.empty_cache()
    # AccIHT (IHTO), one build of the whole budget
    alg = bc.HilbertCoreset(Xc, prj["GIGAO"], seed=seed, snnls=snnls.AccIHT, **on)
    _, t_iht = _synced(lambda: alg.build(G_M, G_M))
    w, p, _ = alg.get()
    kl = rkl(w, p, prior64, post_c)
    log(f"hilbert, IHTO: AccIHT build({G_M}) {t_iht:.3f} s ({alg.snnls.inner_itrs} IHT steps "
        f"after {G_M} GIGA steps), {len(w)} points, error {alg.error():.6g}, reverse KL to the "
        f"contaminated posterior {kl:.6g}; {card}")
    summary.append(f"IHTO {t_iht:.2f} s")
    del alg

    # refine() on the Gaussian SparseVICoreset of phase 13
    svi = bc.SparseVICoreset(Xc, bc.BlackBoxProjector(bc.gaussian_conjugate_sampler(
        prior64[0].float(), eye(G_D), prior64[2].float()), G_S, model=model),
        n_subsample_select=G_N_SEL, n_subsample_opt=G_N_OPT, opt_itrs=G_ITRS,
        step_sched=lambda i: G_I0 / (1.0 + i), seed=seed, max_size=G_M, **on)
    _, t_svi = _synced(lambda: svi.build(H_SVI_SELECTIONS, H_SVI_SELECTIONS))
    before = svi.state.wts.clone()
    w, p, _ = svi.get()
    kl_b = rkl(w, p, prior64, post)
    _, t_ref = _synced(lambda: svi.refine(n_samples=H_REFINE_S))
    w, p, _ = svi.get()
    kl_a = rkl(w, p, prior64, post)
    after = svi.state.wts
    if bool((after < 0).any()) or bool(((after > 0) & (before <= 0)).any()):
        raise AssertionError("refine() left the support or made a weight negative")
    log(f"hilbert, refine() of the Gaussian SparseVICoreset ({H_SVI_SELECTIONS} selections, "
        f"{t_svi:.2f} s): n_samples={H_REFINE_S} over all {Xc.shape[0]} rows {t_ref:.3f} s; "
        f"reverse KL to the clean posterior {kl_b:.6g} -> {kl_a:.6g}; support "
        f"{int((before > 0).sum())} -> {int((after > 0).sum())}; {card}")
    summary.append(f"Gaussian refine {t_ref:.2f} s, rKL {kl_b:.6g} -> {kl_a:.6g}")
    del svi

    # the sharded Hilbert build on the (1, 1) NCCL mesh against the single
    # device, over the clean rows: on the outliers the beta-likelihood
    # underflows to zero projections, which GIGA refuses, and filtering them
    # would change the reductions' lengths and so their float32 rounding
    zero = torch.zeros((1, G_D), device=dev)
    samples, _ = prj["GIGAO"].sampler(gen, G_S, zero[:, 0], zero, zero[0])
    with world_of_one("nccl" if dev == "cuda" else "gloo"):
        mesh = make_mesh(1, 1)
        for beta in (None, H_BETA):
            if beta is None:
                ref = bc.HilbertCoreset(X, bc.BlackBoxProjector(bc.fixed_sampler(samples), G_S,
                                                                model=model), **on).snnls
            else:
                vecs = project_beta(model, X, samples,
                                    torch.tensor(beta, dtype=torch.float32, device=dev))
                ref = snnls.GIGA(vecs.T, vecs.sum(dim=0))
                del vecs
            _, t_ref = _synced(lambda: ref.build(G_M))
            w_ref = ref.w
            sh = ShardedHilbertCoreset(*shard_data(X, mesh), model, samples, mesh, beta=beta)
            _, t_sh = _synced(lambda: sh.build(G_M))
            w_sh = torch.as_tensor(sh.weights(), device=dev)
            scale = float(w_ref.abs().max())
            gap = float((w_sh - w_ref).abs().max())
            mode = "ll" if beta is None else f"beta={beta}"
            log(f"hilbert, ShardedHilbertCoreset ({mode}, NCCL (1, 1) mesh): build({G_M}) "
                f"{t_sh:.3f} s ({t_sh / G_M * 1e3:.3f} ms per greedy iteration, "
                f"{mesh.calls['psum']} psums, {mesh.calls['all_gather']} all_gathers so far) "
                f"against the single-device GIGA's {t_ref:.3f} s; {int((w_sh > 0).sum())} "
                f"points, the same as GIGA's; max |w gap| {gap:.3e} of "
                f"max|w| {scale:.6g}; {card}")
            if not (torch.equal(w_sh > 0, w_ref > 0) and gap <= GRAPH_TOL * scale):
                raise AssertionError(f"the sharded Hilbert build ({mode}) differs from GIGA")
            summary.append(f"sharded {mode} {t_sh / G_M * 1e3:.3f} ms/it")
            del ref, sh, w_ref
    del X, Xc, samples, prj
    torch.cuda.empty_cache()

    # --- the other solvers at the example's own N, against the CPU in float64 ---
    _, Xc5, _, _, _, _, prj5 = gaussian_setup(G_EXAMPLE_N)
    alg = bc.HilbertCoreset(Xc5, prj5["GIGAO"], seed=seed, **on)
    A, b = alg.snnls.A, alg.snnls.b
    A64, b64 = A.double().cpu(), b.double().cpu()
    for name in ("FrankWolfe", "OrthoPursuit", "LAR"):
        cls = getattr(snnls, name)
        want = cls(A64, b64).build_trace(H_OTHER_M)
        got, t_card = _synced(lambda: cls(A, b).build_trace(H_OTHER_M))
        got64 = cls(A.double(), b.double()).build_trace(H_OTHER_M).cpu()
        gap = float((got.double().cpu() - want).abs().max() / want.abs().max())
        first32, first64 = _first_departure(got.cpu(), want), _first_departure(got64, want)
        log(f"hilbert, {name} at N={Xc5.shape[0]}: build_trace({H_OTHER_M}) {t_card:.3f} s "
            f"({t_card / H_OTHER_M * 1e3:.3f} ms per greedy iteration); against the CPU "
            f"float64 solver the card's columns depart after iteration {first32} in float32 "
            f"(weights within {gap:.3e} of its max|w|), {first64} in float64")
        # LAR's events are ratios of FISTA re-solves, which float32 resolves
        # to about 1e-4: its float32 path departs from float64's (after
        # iteration 20 of 50 on this problem on the CPU), so LAR is held to
        # the CPU in float64 only
        if first64 is not None or (first32 is not None and name != "LAR"):
            raise AssertionError(f"{name}: the card's columns depart from the CPU's")
        summary.append(f"{name} {t_card / H_OTHER_M * 1e3:.2f} ms/it")
    for name in ("ImportanceSampling", "UniformSampling"):
        cls = getattr(snnls, name)
        on_card, on_cpu = cls(A, b, seed=seed), cls(A64, b64, seed=seed)
        draws = snnls.sampling_draws(torch.Generator(device=dev).manual_seed(seed),
                                     on_card.ps, 64)
        c1, w1 = snnls.sampling_fold(on_card.ps, on_card.counts, draws, H_OTHER_M)
        c2, w2 = snnls.sampling_fold(on_cpu.ps, on_cpu.counts, draws.cpu(), H_OTHER_M)
        gap = float((w1.double().cpu() - w2).abs().max() / w2.abs().max())
        if not torch.equal(c1.double().cpu(), c2) or not gap <= 1e-5:
            raise AssertionError(f"{name}: the card's fold differs from the CPU's ({gap:.3e})")
        _, t_card = _synced(lambda: on_card.build(H_OTHER_M))
        log(f"hilbert, {name} at N={Xc5.shape[0]}: the same counts as the CPU under the same "
            f"{H_OTHER_M} draws, weights within {gap:.3e}; build({H_OTHER_M}) {t_card * 1e3:.2f} ms")
    del alg, A, b, Xc5

    # --- the multiclass Hilbert coreset at examples/multiclass.py's widths ---
    K, d = MC_K, MC_D
    Xm, ym, Zm = bc.gen_synthetic_multiclass(gen, n + MC_N_TEST, d=d, n_classes=K)
    Zc, _ = bc.flip_labels(gen, Zm[:n], K, MC_F_RATE)
    Xt, yt = Xm[n:], ym[n:]
    del Xm, ym, Zm
    mprj = bc.BlackBoxProjector(bc.multiclass_laplace_sampler(K), S,
                                model=multiclass.bundle(K), theta_dim=K * d)
    k2.launches = 0
    alg, t_proj = _synced(lambda: bc.HilbertCoreset(Zc, mprj, seed=seed, **on))
    launches = k2.launches
    if dev == "cuda" and launches != 1:
        raise AssertionError(f"the multiclass Hilbert projection launched K2 {launches} times")
    k2_total += launches
    _, t_b = _synced(lambda: alg.build(MC_M, MC_M))
    w, p, _ = alg.get()
    lj = multiclass.make_log_joint(K)
    ths = laplace_thetas(w, p, K * d, gen, log_joint=lj,
                         grad=multiclass.make_grad_th_log_joint(K),
                         hess=multiclass.make_hess_th_log_joint(K))
    acc = float(multiclass.compute_accuracy(Xt, yt, ths, K))
    log(f"hilbert, multiclass HilbertCoreset: N={n}, K={K}, d={d}, S={S}: projection "
        f"{t_proj:.3f} s ({launches} K2 launch), GIGA build({MC_M}) {t_b:.3f} s "
        f"({t_b / MC_M * 1e3:.3f} ms per greedy iteration), {len(w)} points; held-out "
        f"accuracy of its Laplace posterior {acc:.4f} ({MC_N_TEST} rows); {card}")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"accuracy {acc} outside [0, 1]")
    summary.append(f"multiclass GIGA {t_b / MC_M * 1e3:.3f} ms/it, accuracy {acc:.4f}")
    del alg

    # refine() over every row of a multiclass SparseVICoreset: K2 once more, at S_big
    svi = bc.SparseVICoreset(Zc, mprj, n_subsample_select=None, n_subsample_opt=MC_N_OPT,
                             opt_itrs=MC_OPT_ITRS, seed=seed, max_size=MC_M, **on)
    k2.launches = 0
    svi.build(2, 2)
    k2_total += k2.launches
    before = svi.state.wts.clone()
    k2.launches = 0
    _, t_ref = _synced(lambda: svi.refine(n_samples=H_REFINE_S))
    launches = k2.launches
    if dev == "cuda" and launches != 1:
        raise AssertionError(f"refine() over every row launched K2 {launches} times")
    k2_total += launches
    after = svi.state.wts
    if bool((after < 0).any()) or bool(((after > 0) & (before <= 0)).any()):
        raise AssertionError("refine() left the support or made a weight negative")
    log(f"hilbert, refine() of the multiclass SparseVICoreset: n_samples={H_REFINE_S} over "
        f"all {n} rows {t_ref:.3f} s ({launches} K2 launch), weights "
        f"{before[before > 0].tolist()} -> {after[before > 0].tolist()}; {card}")
    # K2 at that shape (S = 500, the ll variant refine() takes), against its plain version
    ths = torch.randn((H_REFINE_S, K * d), generator=gen, device=dev)
    got = k2(Zc, ths, K, 1.0, False)
    want = kernels.multiclass_projection_plain(Zc[:8192], ths, K, 1.0, False)
    err = float((got[:8192] - want).abs().max())
    if not err <= MC_TOL:
        raise AssertionError(f"K2 at S={H_REFINE_S}: off its plain version by {err:.3e}")
    t_k2, plan = 0.0, "not built"
    if dev == "cuda":
        t_k2 = _time_ms(lambda: k2(Zc, ths, K, 1.0, False), 20)
        plan = kernels.mc_plan_built(d, K, H_REFINE_S, torch.cuda.get_device_properties(
            dev).shared_memory_per_block_optin)
    bound = mc_bound(n, H_REFINE_S, K, d, False)
    log(f"hilbert, K2 at N={n}, S={H_REFINE_S}, K={K}, d={d} (ll): {t_k2:.4f} ms (CUDA events), "
        f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, max|kernel-plain| on 8192 "
        f"rows {err:.3e}; plan {plan}; {card}")
    summary.append(f"K2 at S={H_REFINE_S} {t_k2:.4f} ms")
    del svi, Zc, Xt, yt, got, want
    torch.cuda.empty_cache()
    log(f"hilbert: phase 14 in {time.perf_counter() - t_phase:.1f} s; {k2_total} K2 launches")
    return {"K2": k2_total, "line": "hilbert: " + ", ".join(summary)}


def movielens_groups(trial: int = 0, f_rate: float = GRP_F_RATE):
    """examples/group_selection.py:56-100 on the repo's movielens data,
    inline with numpy: whitened covariates (``std_cov``), the 100 groups of
    the pickle, each group's rows corrupted in proportion to its
    demographic fraction (half the columns replaced by N(0, 10) noise and
    the label flipped), the test set rebalanced and whitened alike.
    Returns float32 (Z, Xt, Yt) and the group lists."""
    import pickle
    from pathlib import Path

    root = Path(__file__).resolve().parent / "data"
    with np.load(root / "movielens_grouped.npz") as npz:
        X, Y, Xt, Yt = (np.asarray(npz[k], dtype=np.float64) for k in ("X", "y", "Xt", "yt"))
    if set(np.unique(Y)) <= {0.0, 1.0}:
        Y, Yt = 2.0 * Y - 1.0, 2.0 * Yt - 1.0

    def std_cov(X, Y, mean=None, cov=None):
        X = np.array(X, copy=True)
        if mean is None:
            mean = X[:, :-1].mean(axis=0)
            cov = np.cov(X[:, :-1], rowvar=False) + 1e-12 * np.eye(X.shape[1] - 1)
        L = np.linalg.cholesky(np.atleast_2d(cov))
        X[:, :-1] = np.linalg.solve(L, (X[:, :-1] - mean).T).T
        return X, Y, mean, cov

    X, Y, mean, cov = std_cov(X, Y)
    with open(root / "vq_groups_sensemake_movielens_grouped.pk", "rb") as fh:
        groups, demos = pickle.load(fh)
    groups = [[int(k) for k in g if int(k) < X.shape[0]] for g in groups]
    rng = np.random.default_rng(trial)
    for g, dem in zip(groups, demos):
        o = int(len(g) * min(dem[0] * f_rate * 3, 0.9))
        if o > 0:
            rows = rng.choice(g, size=o, replace=False)
            for c in rng.choice(X.shape[1], max(X.shape[1] // 2, 1), replace=False):
                X[rows, c] = rng.normal(0, 10, size=o)
            Y[rows] = -Y[rows]
    Z = Y[:, None] * X
    # the majority test label truncated for a balanced test set
    rnd = np.random.default_rng(42).uniform()
    n_pos = (Yt == 1).sum()
    if not 0.45 * len(Yt) <= n_pos <= 0.55 * len(Yt):
        maj = 1.0 if n_pos > len(Yt) - n_pos else -1.0
        keep_min = np.where(Yt == -maj)[0]
        keep_maj = np.where(Yt == maj)[0][:len(keep_min) + int(0.01 * len(keep_min) * rnd)]
        keep = np.concatenate([keep_maj, keep_min])
        Xt, Yt = Xt[keep], Yt[keep]
    Xt, Yt, _, _ = std_cov(Xt, Yt, mean, cov)
    return Z.astype(np.float32), Xt.astype(np.float32), Yt.astype(np.float32), groups


def phase_groups(seed: int, card: str, selections: int, dev: str = "cuda") -> dict:
    """Phase 15: group (batch) selection, the BPSVI family and group data
    valuation at full width (the module docstring's a-e). Returns K2's
    launches in the phase and one summary line."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.coresets import (bpsvi_build_batch, group_ids_from_groups,
                                              init_group_state, make_group_incremental_builder)
    from betacores_tpu_torch.models import gaussian
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.valuation import (logreg_laplace_value_fn, make_dshapley,
                                               make_tmc_shapley)

    t_phase = time.perf_counter()
    on = {} if dev == "cuda" else {"device": dev}
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    k2 = kernels.multiclass_projection
    summary = []

    # --- a. examples/group_selection.py on the repo's movielens groups ---
    Z, Xt, Yt, glists = movielens_groups()
    Zd, Xtd, Ytd = (torch.from_numpy(a).to(dev) for a in (Z, Xt, Yt))
    G, N = len(glists), Z.shape[0]
    log(f"groups a, movielens: N={N} x d={Z.shape[1]}, {G} groups, {len(Yt)} test rows "
        f"after rebalancing")
    prj = bc.BetaBlackBoxProjector(bc.logreg_laplace_sampler(), GRP_S, model=bc.logreg.bundle())
    alg = bc.BetaCoreset(Zd, prj, beta=GRP_BETA, learn_beta=False, opt_itrs=GRP_ITRS,
                         n_subsample_select=None, n_subsample_opt=GRP_N_OPT, groups=glists,
                         seed=seed, **on)
    if alg._builder.onehot is None:
        raise AssertionError("the movielens group build should take the one-hot reduction")
    order, prev, itrs = [], np.zeros(G, dtype=bool), 0
    t0 = time.perf_counter()
    for _ in range(4):                  # the example's loop: until M distinct groups
        _, sel = alg.build_trace(GRP_M, return_selected=True)
        itrs += GRP_M
        for row in sel:
            order.extend(np.flatnonzero(row & ~prev).tolist())
            prev = row
        if len(order) >= GRP_M:
            break
    torch.cuda.synchronize()
    t_bcores = time.perf_counter() - t0
    order = order[:GRP_M]
    check_state(alg.state)
    log(f"groups a, BCORES(groups=) order {order}: {itrs} selections in {t_bcores:.3f} s, "
        f"{t_bcores / itrs:.4f} s per selection, {t_bcores / (itrs * GRP_ITRS) * 1e6:.1f} us "
        f"per Adam step (with select); m={int(alg.state.m)}; {card}")
    gp = Groups.from_lists(glists, dev)
    gid = group_ids_from_groups(gp, N)
    value_fn = logreg_laplace_value_fn(n_samples=256)
    vargs = (Zd, Xtd, Ytd)
    fits = [0]

    class Counted:
        draw = value_fn.draw

        def __call__(self, *a):
            fits[0] += 1
            return value_fn(*a)

    dshap = make_dshapley(gid, gp, Counted(), max_groups=min(SHAP_GROUPS, G),
                          group_cap=SHAP_CAP, value_args=vargs)
    phis, secs = _synced(lambda: dshap(gen, SHAP_T))
    n_fits, fits[0] = fits[0], 0
    if not bool(torch.isfinite(phis).all()):
        raise AssertionError(f"DShapley: non-finite values {phis.tolist()}")
    d_order = torch.argsort(phis, descending=True)[:GRP_M].tolist()
    log(f"groups a, DShapley (T={SHAP_T}, cap {SHAP_CAP}, {min(SHAP_GROUPS, G)} groups a "
        f"permutation): top {d_order}; {n_fits} fits in {secs:.3f} s, "
        f"{secs / n_fits * 1e3:.2f} ms per fit; {card}")
    full_value = float(value_fn(value_fn.draw(gen, *vargs), (gid < G).float(), *vargs))
    tmc = make_tmc_shapley(gid, gp, Counted(), full_value=full_value, group_cap=SHAP_CAP,
                           value_args=vargs)
    phis_t, secs = _synced(lambda: tmc(gen, TMC_T))
    n_fits = fits[0]
    if not bool(torch.isfinite(phis_t).all()) or not 0 < n_fits <= TMC_T * G:
        raise AssertionError(f"TMC: {n_fits} fits, values {phis_t.tolist()}")
    log(f"groups a, TMC (T={TMC_T}, full-data value {full_value:.4f}): top "
        f"{torch.argsort(phis_t, descending=True)[:GRP_M].tolist()}; {n_fits} fits of "
        f"{TMC_T * G} (the rest truncated) in {secs:.3f} s, {secs / n_fits * 1e3:.2f} ms "
        f"per fit; {card}")
    mask, accs = torch.zeros(N, dtype=torch.bool, device=dev), []
    for g in order:
        mask[glists[g]] = True
        accs.append(float(value_fn(value_fn.draw(gen, *vargs), mask.float(), *vargs)))
    if not all(0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"prefix accuracies outside [0, 1]: {accs}")
    log(f"groups a, prefix accuracies of the BCORES order: "
        f"{', '.join(f'{a:.4f}' for a in accs)}")
    summary.append(f"movielens BCORES {t_bcores / itrs:.3f} s/selection, final acc "
                   f"{accs[-1]:.4f}")
    del alg, Zd, Xtd, Ytd, dshap, tmc

    # --- b. the group build of examples/bench_group_pass.py --end-to-end ---
    X, y, _ = bc.gen_synthetic_logreg(gen, GB_N, d=N_FEAT)
    X, y, Zb, _ = bc.perturb_logreg(gen, X, y, f_rate=0.1)
    del X, y
    per = GB_N // GB_G
    gp = Groups.from_lists([range(g * per, (g + 1) * per) for g in range(GB_G)], dev)
    cfg = bc.IncrementalConfig(projection_dim=S, n_subsample_select=None, n_subsample_opt=None,
                               opt_itrs=GB_ITRS, i0=1.0, use_beta=True)
    make = lambda graph: make_group_incremental_builder(
        Zb, gp, bc.logreg.bundle(), bc.logreg_laplace_sampler(), cfg, graph=graph)
    builder = make(None)
    if builder.onehot is not None:
        raise AssertionError("N G 4 bytes above the gate: the build should scatter")
    gst0 = init_group_state(bc.init_state((GB_M + 1) * per, N_FEAT, beta=GB_BETA, device=dev),
                            GB_G)
    _, t_warm = _synced(lambda: builder.build(gst0, 1, builder.generator_draws(gen)))
    gen_state = gen.get_state()
    got, secs = _synced(lambda: builder.build(gst0, selections, builder.generator_draws(gen)))
    eager = make(False)
    gen.set_state(gen_state)
    ref, secs_e = _synced(lambda: eager.build(gst0, selections, eager.generator_draws(gen)))
    check_state(got.core)
    if not torch.equal(got.selected, ref.selected):
        raise AssertionError("group build: captured and eager select other groups")
    same = check_graph_equals_eager("group build", got.core, ref.core)
    steps = selections * GB_ITRS
    log(f"groups b, logistic group build: N={GB_N}, G={GB_G} groups of {per}, buffer "
        f"{(GB_M + 1) * per} slots, S={S}, exact-gradient refinement ({GB_ITRS} steps); "
        f"warm-up selection {t_warm:.2f} s; {selections} selections captured {secs:.3f} s "
        f"({secs / selections:.4f} s per selection, {secs / steps * 1e3:.3f} ms per Adam step), "
        f"eager {secs_e:.3f} s ({secs_e / steps * 1e3:.3f} ms per step); selected "
        f"{torch.nonzero(got.selected)[:, 0].tolist()}, m={int(got.core.m)}; {card}")
    log(f"groups b, captured == eager: {same}")
    summary.append(f"logistic group build {secs / selections:.3f} s/selection captured, "
                   f"{secs_e / selections:.3f} eager")
    del builder, eager, got, ref, Zb, gp
    torch.cuda.empty_cache()

    # --- c. the multiclass group build: K2 in select and in every step ---
    K, d = MC_K, MC_D
    _, _, Zm = bc.gen_synthetic_multiclass(gen, GC_N, d=d, n_classes=K)
    Zm, _ = bc.flip_labels(gen, Zm, K, MC_F_RATE)
    per = GC_N // GC_G
    gp = Groups.from_lists([range(g * per, (g + 1) * per) for g in range(GC_G)], dev)
    cfg = bc.IncrementalConfig(projection_dim=S, n_subsample_select=None, n_subsample_opt=None,
                               opt_itrs=GC_ITRS, i0=1.0, use_beta=True)
    builder = make_group_incremental_builder(Zm, gp, bc.multiclass.bundle(K),
                                             bc.multiclass_laplace_sampler(K), cfg)
    gst0 = init_group_state(bc.init_state(GC_BUF_GROUPS * per, d + 1, beta=MC_BETA, device=dev,
                                          sampler_aux=torch.zeros(K * d, device=dev)), GC_G)
    _, t_warm = _synced(lambda: builder.build(gst0, 1, builder.generator_draws(gen)))
    k2.launches = 0
    got, secs = _synced(lambda: builder.build(gst0, selections, builder.generator_draws(gen)))
    launches = k2.launches
    # select: every row and the buffer; each step: every row and the buffer
    per_sel = 2 + 2 * GC_ITRS if kernels.maybe_fused(GC_BUF_GROUPS * per) else 1 + GC_ITRS
    if dev == "cuda" and launches != selections * per_sel:
        raise AssertionError(f"multiclass group build: K2 launched {launches} times, want "
                             f"{selections * per_sel}")
    check_state(got.core)
    steps = selections * GC_ITRS
    log(f"groups c, multiclass group build: N={GC_N}, K={K}, d={d}, G={GC_G} groups of {per}, "
        f"buffer {GC_BUF_GROUPS * per} slots, S={S}, {GC_ITRS} exact-gradient steps; warm-up "
        f"{t_warm:.2f} s; {selections} selections {secs:.3f} s ({secs / selections:.4f} s per "
        f"selection, {secs / steps * 1e3:.3f} ms per Adam step); {launches} K2 launches "
        f"(replayed ones counted); selected {torch.nonzero(got.selected)[:, 0].tolist()}; "
        f"{card}")
    summary.append(f"multiclass group build {secs / selections:.3f} s/selection, "
                   f"{launches} K2")
    del builder, got, Zm, gp
    torch.cuda.empty_cache()
    group_self_check(seed, dev)

    # --- d. BPSVI at examples/zellner_logreg.py's widths over the headline's rows ---
    X, y, _ = bc.gen_synthetic_logreg(gen, N_ROWS, d=N_FEAT)
    X, y, Zp, _ = bc.perturb_logreg(gen, X, y, f_rate=0.1)
    del X, y
    sched = lambda m: (lambda i: 1.0 / (1.0 + i))
    prj = bc.BlackBoxProjector(bc.logreg_laplace_sampler(), S, model=bc.logreg.bundle())
    bp = bc.BatchPSVICoreset(Zp, prj, opt_itrs=BP_ITRS, n_subsample_opt=N_OPT,
                             step_sched=sched, seed=seed, max_size=BP_M, **on)
    _, secs = _synced(lambda: bp.build(1, BP_M))
    w, p, i = bp.get()
    if not np.isfinite(w).all() or not np.isfinite(p).all() or len(w) < 1:
        raise AssertionError("BPSVI: non-finite or empty coreset")
    log(f"groups d, BatchPSVICoreset.build(1, {BP_M}) over N={N_ROWS}: {secs:.3f} s, "
        f"{secs / BP_ITRS * 1e6:.1f} us per Adam step (captured after the first); "
        f"{len(w)} positive weights, sum(w)={w.sum():.1f}; {card}")
    builder = bp._builder_for(BP_M)
    aux0 = torch.zeros(N_FEAT, device=dev)
    lane_draws = [builder.draws(gen, BP_M, aux0) for _ in BP_SIZES]
    (W, P, I), secs = _synced(lambda: bpsvi_build_batch(builder, lane_draws, BP_SIZES, BP_M,
                                                        aux0))
    errs = []
    for lane, sz in enumerate(BP_SIZES):
        w1, p1, _ = builder.build(lane_draws[lane], BP_M, aux0,
                                  torch.arange(BP_M, device=dev) < sz)
        scale = float(w1.abs().max())
        err = float((W[lane] - w1).abs().max())
        if not err <= 1e-6 * scale or bool((W[lane, sz:] != 0).any()):
            raise AssertionError(f"BPSVI lane {sz}: off its standalone build by {err:.3e} "
                                 f"(max|w| {scale:.3e}) or a masked slot weighs")
        errs.append(err)
    log(f"groups d, bpsvi_build_batch over sizes {BP_SIZES} (lanes in turn): {secs:.3f} s, "
        f"{secs / len(BP_SIZES):.3f} s per lane; each lane == its standalone masked build "
        f"(max |dw| {max(errs):.3e}); {card}")
    summary.append(f"BPSVI {secs / len(BP_SIZES) / BP_ITRS * 1e6:.0f} us/step")
    del bp, builder, Zp, W, P, I
    torch.cuda.empty_cache()

    # --- e. DP-BPSVI at examples/dp_bpsvi.py's defaults, and PSVI on its data ---
    Xd = torch.randn((DP_N, DP_D), generator=gen, device=dev) + 1.0
    eye = torch.eye(DP_D, device=dev)
    prj = bc.BlackBoxProjector(bc.gaussian_conjugate_sampler(torch.zeros(DP_D, device=dev),
                                                             eye, eye), S,
                               model=gaussian.bundle(eye, 0.0))
    dp = bc.DiffPrivBatchPSVICoreset(Xd, prj, opt_itrs=DP_ITRS, n_subsample_opt=DP_N_OPT,
                                     step_sched=sched, noise_multiplier=DP_NM, delta=DP_DELTA,
                                     seed=seed, **on)
    _, secs = _synced(lambda: dp.build(1, DP_M))
    w, p = dp.get()
    eps = dp.epsilon(DP_DELTA)
    if not np.isfinite(p).all() or len(w) < 1 or not 0 < eps < float("inf"):
        raise AssertionError(f"DP-BPSVI: {len(w)} points, eps {eps}")
    log(f"groups e, DP-BPSVI: N={DP_N}, d={DP_D}, M={DP_M}, {DP_ITRS} steps on Poisson "
        f"batches of {DP_N_OPT} rows, noise multiplier {DP_NM}: eps = {eps:.4f} at delta = "
        f"{DP_DELTA}; {secs:.3f} s, {secs / DP_ITRS * 1e6:.1f} us per Adam step; {len(w)} "
        f"positive weights; {card}")
    psvi = bc.PseudoSparseVICoreset(Xd, prj, n_subsample_opt=DP_N_OPT, opt_itrs=DP_ITRS,
                                    step_sched=sched(0), seed=seed, max_size=DP_M, **on)
    _, secs = _synced(lambda: psvi.build(PSVI_SELECTIONS, PSVI_SELECTIONS))
    w, p, i = psvi.get()
    if not np.isfinite(p).all() or len(w) < 1:
        raise AssertionError("PSVI: non-finite or empty coreset")
    log(f"groups e, PseudoSparseVICoreset: {PSVI_SELECTIONS} selections in {secs:.3f} s, "
        f"{secs / PSVI_SELECTIONS:.4f} s per selection, "
        f"{secs / (PSVI_SELECTIONS * DP_ITRS) * 1e6:.1f} us per Adam step; m="
        f"{int(psvi.state.m)}; {card}")
    summary.append(f"DP eps {eps:.3f}")
    log(f"groups: phase 15 in {time.perf_counter() - t_phase:.1f} s; {launches} K2 launches")
    return {"K2": launches, "line": "groups: " + ", ".join(summary)}


def group_self_check(seed: int, dev: str = "cuda") -> None:
    """A small multiclass group build (N = 9000 > FUSED_MIN_ROWS, every
    step over every row, so each select and step launches K2 on the card)
    equals the same build on the CPU (K2's plain version) under one set of
    draws, in both select modes."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.coresets import (FixedDraws, init_group_state,
                                              make_group_incremental_builder)
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.ops.projection import Groups

    N, K, d, S_s, itrs, T = 9000, 3, 4, 32, 3, 20
    gen = torch.Generator().manual_seed(seed)
    _, _, Z = bc.gen_synthetic_multiclass(gen, N, d=d, n_classes=K)
    Z, _ = bc.flip_labels(gen, Z, K, MC_F_RATE)
    lists = [range(g * 100, (g + 1) * 100) for g in range(N // 100 - 1)]
    for dedup, refit_every in ((False, 1), (True, 4)):
        cfg = bc.IncrementalConfig(projection_dim=S_s, n_subsample_select=None,
                                   n_subsample_opt=None, opt_itrs=T, i0=0.5, use_beta=True,
                                   dedup_select=dedup, refit_every=refit_every)
        out = {}
        for where in ("cpu", dev):
            b = make_group_incremental_builder(Z.to(where), Groups.from_lists(lists, where),
                                               bc.multiclass.bundle(K),
                                               bc.multiclass_laplace_sampler(K), cfg)
            gst0 = init_group_state(bc.init_state(400, d + 1, beta=MC_BETA, device=where,
                                                  sampler_aux=torch.zeros(K * d,
                                                                          device=where)),
                                    len(lists))
            if where == "cpu":
                rec = b.generator_draws(gen)
                draws = FixedDraws([rec.select(i, gst0.core) for i in range(itrs)],
                                   [rec.optimize(i, gst0.core) for i in range(itrs)])
            before = kernels.multiclass_projection.launches
            out[where] = (b.build(gst0, itrs, draws),
                          kernels.multiclass_projection.launches - before)
        tag = f"group self-check [dedup_select={dedup}, refit_every={refit_every}]"
        if dev != "cpu" and out[dev][1] != itrs * (1 + T):
            raise AssertionError(f"{tag}: K2 launched {out[dev][1]} times, want {itrs * (1 + T)}")
        if not torch.equal(out[dev][0].selected.cpu(), out["cpu"][0].selected):
            raise AssertionError(f"{tag}: the card selects other groups than the CPU")
        log(f"{tag}: build on the card == build on the CPU "
            f"({check_same_build(tag, out[dev][0].core, out['cpu'][0].core)})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--selections", type=int, default=5)
    ap.add_argument("--mc-selections", type=int, default=3)
    ap.add_argument("--sharded-selections", type=int, default=3)
    ap.add_argument("--api-selections", type=int, default=5)
    ap.add_argument("--group-selections", type=int, default=3)
    args = ap.parse_args()

    t_start = time.perf_counter()
    name, card = phase_device()
    phase_build()
    k1 = phase_kernel(args.seed)
    k2 = phase_mc_kernel(args.seed)
    k3 = phase_shard_kernel(args.seed)
    main_path = phase_main_path(args.seed, N_ROWS, args.selections)
    phase_self_check(args.seed)
    mc_path = phase_mc_path(args.seed, MC_ROWS, args.mc_selections)
    phase_mc_self_check(args.seed)
    sharded = phase_sharded_path(args.seed, N_ROWS, args.sharded_selections)
    phase_sharded_self_check(args.seed)
    phase_bench(args.seed, N_ROWS)
    api = phase_api(args.seed, N_ROWS, args.api_selections)
    families = phase_families(args.seed, card)
    hilbert = phase_hilbert(args.seed, card)
    groups = phase_groups(args.seed, card, args.group_selections)
    entries = [("logreg_adam_step", "logreg_adam_step.cu", "pallas_kernels.py:173",
                {"launches": main_path["launches"] + api["K1"]}, k1),
               ("multiclass_projection", "multiclass_projection.cu", "pallas_kernels.py:330",
                {"launches": mc_path["launches"] + api["K2"] + hilbert["K2"] + groups["K2"]},
                k2),
               ("logreg_shard_step_partials", "logreg_shard_partials.cu", "pallas_kernels.py:249",
                sharded, k3)]
    log(families)
    log(hilbert["line"])
    log(groups["line"])
    log(f"chip_smoke: phases 0-15 in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"betacores_tpu_torch/csrc/{src}",
         "replaces": f"betacores_tpu/ops/{tpu}", "launches": path["launches"], **k}
        for name, src, tpu, path, k in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
