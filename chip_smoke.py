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
     CPU float64 solver's at every iteration, in float32 and in float64,
     and the sampling solvers folding the same draws as the CPU;
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
     ``PseudoSparseVICoreset`` for 5 selections on that data;
 16. the neural-linear experiment (``phase_neural_linear``), the
     contextual builds: (a) examples/zellner_neural_linear.py at its
     defaults (synth N = 2000, D = 12, groups of 20, 10 % of them corrupted,
     F = 30, S = 100, 500 Adam steps on 1000 rows, 20 rounds (SVI and RAND
     10, to keep the script within its time), the encoder
     retrained 200 epochs a round) for BCORES, SVI and RAND, printing the
     test RMSE and NLL at rounds 0, 5, 10, 15, 20 beside the JAX package's
     recorded trajectory; (b) a contextual group ``BetaCoreset`` over 2^19
     rows at YearPredictionMSD's width (D = 90), each selection captured
     and then again eager under the same draws and context (the encoder
     retrained between, so later replays run under a new one), with µs a
     step, ms a select, s a retraining and the peak memory; (c) a small
     contextual group build and a 5-epoch training of each variant on the
     card against the CPU. K1, K2 and K3 launch 0 times in it;
 17. the MCMC evaluation and the sparse Hamiltonian flows
     (``phase_mcmc_eval``): (a) examples/zellner_logreg.py at its defaults,
     a BetaCoreset of 100 points over synth_lr's 12,000 rows (K1 every Adam
     step) scored at every ZL_CUT_EVERY-th size by 2 HMC chains of 1000 + 1000
     iterations through ``run_with_escalation``, each iteration a replayed
     CUDA graph; (b) NUTS at m = 100 and the 5000-row full-data baseline;
     (c) an escalation to NUTS that happens by itself; (d)
     examples/shf_logreg.py at its defaults (6000 captured Adam steps of a
     double backward) and its HMC baseline; (e) captured == eager and card
     == CPU (float64) for HMC, NUTS and the flow's training;
 18. the streamed merge-reduce build and the host I/O (``phase_streaming``):
     (a) examples/streaming_build.py at its widths (200,000 contaminated
     logistic rows kept on the host, 4 leaves of 50,000 rows streamed
     through one builder, the weighted final build over the union; the
     selections cut by SB_CUT_LEAF and SB_CUT_FINAL), which must beat the
     prior's held-out accuracy, and ``parallel_leaves=True`` giving the
     same leaf bits; (b) examples/streaming_outofcore.py --n 20_000_000
     --chunk 5_000_000 (800 MB of host data, a checkpoint a leaf), whose
     peak device memory must stay below two chunks plus the pass buffers
     and whose reverse KL to the exact posterior must beat the prior's;
     (c) a crash and its resume from the checkpoint, bit for bit; (d) the
     mesh leaf pass on a (1, 1) NCCL mesh, bit for bit; (e) the native CSV
     parser against numpy on a 100 MB file; (f) ``save_state`` /
     ``load_state`` between two halves of a build; (g) ``Timings`` and one
     ``trace`` written under chiprun_out/. K1, K2 and K3 launch 0 times in
     it;
 19. the rest of parallel/ (``phase_parallel``), every mesh a (1, 1) NCCL
     world of one rank, each entry point held against its single-device
     counterpart on the card under the same draws: (a) the sharded
     exact-gradient logistic group build of phase 15 (b)'s widths for
     PAR_GB_SELECTIONS selections after a warm-up (groups, m, idcs equal,
     weights within 1e-6 max|w|); (b) the sharded multiclass group build of
     phase 15 (c)'s widths, one selection after a warm-up, K2 launched 402
     times (the local rows and the buffer at select and every step, the
     samp = 1 route), then at N = 9000 on the card against the
     single-device build on the CPU in both select modes; (c)
     ``make_sharded_bpsvi_batch`` over sizes 10, 50, 100 at phase 15 (d)'s
     widths, every lane bit for bit ``bpsvi_build_batch``'s; (d)
     ``run_chains_sharded``, HMC and NUTS, 2 chains of 1000 + 1000 on phase
     17's m = 100 coreset, every chain ``run_chains``'s (``run_chains_nuts``'s)
     within 1e-6; (e) ``make_sharded_shf_trainer`` at examples/shf_logreg.py's
     widths for PAR_SHF_STEPS of its 6000 steps, bit for bit
     ``make_shf_trainer``'s; (f) DShapley (T = 50) and TMC (T = 5) with
     ``mesh=`` on phase 15 (a)'s movielens groups, equal to ``mesh=None``
     under the same ``PermutationDraws``; (g) the sharded NIW build at
     examples/mvn_unknown_cov.py's widths over 2^20 rows plus outliers for
     PAR_V_SELECTIONS selections, equal to the single-device per-step-draw
     build under one generator (``check_same_build``'s 5e-3 max(1, max|w|):
     the two centre the projections in another order).
 20. the build as a loadable program and the ported drivers
     (``phase_export``): (a) the headline build of phase 4 exported on the
     card (``utils.export.export_incremental_build``: an outer while_loop
     over selections, the refinement an inner one, every Adam step K1's
     ``torch.library`` op) with its draws stacked for EXP_STACK selections,
     saved, loaded by a fresh process that imports ``utils.export`` and no
     builder or model family, run at 2 and 3 selections from that one
     artifact and held against the live, graph-captured build on the same
     draws (``check_same_build``; prints whether bit-identical and the
     seconds a selection of both); (b) the multiclass build of phase 6
     exported the same way, run at 2 selections, K2's op once a select;
     (c) every ported driver (``python -m betacores_tpu_torch.examples.<name>``)
     once through its ``main()`` at its defaults cut in depth (EX_CUTS),
     each pickle carrying the JAX driver's keys (EX_KEYS) with finite
     numbers, ``run_sweep`` at one grid point and ``plot_results`` (skipped,
     and said, without matplotlib).
 21. the rest of the ported drivers and the entry points
     (``phase_drivers``), each through its ``main(argv)``: (a) dp_bpsvi at
     its defaults, every finite-eps row's reverse KL below a tenth of the
     prior's; (b) virtual_mesh_headline --mesh 1x1 (an NCCL world of one)
     at full width for MESH_ITRS selections, K3 launched 500 times a
     selection, then --full-data, --full-gradient and --census (the
     design's collective counts); (c) preprocess covtype, mnist2, housing
     and movielens on raw files it writes, and data_tabulate over them; (d)
     bench_native_loader, bench_select_pass, bench_group_pass and
     fulldata_roofline --configs fullopt, at cut repetitions; (e)
     ``betacores_tpu_torch.entry.entry()`` once (K1 ten times) and
     ``dryrun_multichip(1)`` (NCCL, every subsystem). Phase 18 (a) and (b)
     run the ported streaming_build and streaming_outofcore drivers.
Phase 14 also builds GIGAO and GIGAR at examples/zellner_gaussian.py's own
N = 5000 and raises if either reverse KL is more than an order of magnitude
off the JAX package's record.

The last two lines of standard output are a JSON object describing the
kernels (K1 and K3 add ``bound_us`` and ``floor_us``, K2 ``floor_ms``), then
{"ok": true, "device": {...}}. Without a card the script exits nonzero and
prints neither.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
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
# phase 16: examples/zellner_neural_linear.py's defaults (:54-83): train rows, test
# rows, --D, --batch-size (group size), --init-size, --f-rate; --out-features,
# --proj-dim, --opt-itrs, --n-subsample-opt, --i0, --beta, --M; --nn-epochs,
# --initial-lr, --weight-decay; the rounds whose test RMSE and NLL are printed
NL_N, NL_N_TEST, NL_D, NL_GROUP, NL_INIT, NL_F_RATE = 2000, 1500, 12, 20, 20, 0.1
NL_F, NL_S, NL_ITRS, NL_N_OPT, NL_I0, NL_BETA, NL_M = 30, 100, 500, 1000, 0.1, 0.5, 20
NL_EPOCHS, NL_LR, NL_WD, NL_ROUNDS = 200, 1e-2, 0.1, (0, 5, 10, 15, 20)
# SVI and RAND run this many of the rounds (BCORES all of them), to keep the
# script within its time (PERF.md)
NL_CUT_ROUNDS = 5
# the JAX package's test RMSE at rounds 0 and 20 of that example (RESULTS.md:236-238)
NL_JAX_RMSE = {"BCORES": (24.6, 28.9), "RAND": (24.6, 71.7)}
# and at scale: 2^19 rows at YearPredictionMSD's width, the largest set the
# reference's loaders read (betacores_tpu/data/loaders.py:189-191), selections after a warm-up
NLB_N, NLB_D, NLB_SELECTIONS = 1 << 19, 90, 3
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
# phase 17: examples/zellner_logreg.py at its defaults: synth_lr's --synth-N and
# --synth-d and its test rows (max(2000, N // 6)), --f-rate, --trial, --beta,
# --proj-dim, --opt-itrs, --n-subsample-opt, --n-subsample-select, --i0, --M,
# --eval-every, --mcmc-samples, --mcmc-warmup, --mcmc-chains, L_max, --full-data-cap
ZL_N, ZL_D, ZL_N_TEST, ZL_F_RATE, ZL_TRIAL, ZL_BETA = 12_000, 10, 2000, 0.1, 1, 0.1
ZL_S, ZL_ITRS, ZL_N_OPT, ZL_N_SEL, ZL_I0, ZL_M, ZL_EVERY = 100, 500, 200, 1000, 1.0, 100, 10
ZL_SAMPLES, ZL_WARMUP, ZL_CHAINS, ZL_L_MAX, ZL_FULL_CAP = 1000, 1000, 2, 32, 5000
# the sizes the phase scores: every ZL_CUT_EVERY-th (of --eval-every's ZL_EVERY), to keep
# the script within its time (PERF.md)
ZL_CUT_EVERY = 20
# the JAX package's test accuracy of BCORES on synth_lr at m = 100 (RESULTS.md:440-442)
ZL_JAX_ACC_M100 = (0.993, 0.995)
# tests/test_inference.py:354-373's ill-conditioned target: d, chains, draws,
# warmup, and the HMC primary's L_max
ESC_D, ESC_CHAINS, ESC_SAMPLES, ESC_WARMUP, ESC_L_MAX = 6, 4, 700, 500, 16
# examples/shf_logreg.py's defaults (N, d, M, blocks, leapfrog steps, n_mc, batch,
# steps, chunk, samples, rate) and the JAX record of its accuracies, flow and HMC
# (RESULTS.md:494-497)
SHF_N, SHF_D, SHF_M, SHF_BLOCKS, SHF_LEAP, SHF_MC, SHF_B = 20_000, 5, 30, 4, 8, 8, 256
SHF_STEPS, SHF_CHUNK, SHF_SAMPLES, SHF_LR = 6000, 2000, 2000, 1e-2
SHF_JAX_ACC = (0.9547, 0.9548)
# the JAX package's reverse KLs of GIGAO and GIGAR at examples/zellner_gaussian.py's
# N = 5000, M = 200, and the prior's (RESULTS.md:37-40)
H_JAX_RKL = {"GIGAO": 4.6e5, "GIGAR": 1.9e5, "PRIOR": 4.9e3}
# phase 18: examples/streaming_build.py at its defaults: --N, --d, --chunk-size,
# --f-rate, --m-leaf, --m-final, --m-buf, --proj-dim, --opt-itrs, --beta, the select
# and refinement subsamples, the final build's Adam steps (max(--opt-itrs, 500), over
# every union row)
SB_N, SB_D, SB_CHUNK, SB_F_RATE, SB_M_LEAF, SB_M_FINAL, SB_M_BUF = 200_000, 10, 50_000, 0.1, 50, 100, 64
SB_S, SB_ITRS, SB_BETA, SB_N_SEL, SB_N_OPT, SB_FINAL_ITRS = 100, 300, 0.1, 1000, 200, 500
# the selections the phase runs of them, leaf and final, to keep the script within its
# time (PERF.md): the final build's full-data refinement runs eagerly
SB_CUT_LEAF, SB_CUT_FINAL = 5, 3
# examples/streaming_outofcore.py's small usage line (--n, --chunk) with its other
# defaults (--d, --m-leaf = --m-final, --proj-dim, --opt-itrs, the refinement
# subsample), and the selections run of them
OC_N, OC_CHUNK, OC_D, OC_M, OC_S, OC_ITRS = 20_000_000, 5_000_000, 10, 100, 100, 300
OC_N_OPT, OC_CUT_M = 200, 25
# the crash and resume, mesh and state-checkpoint checks at a small depth: rows,
# chunk, selections, Adam steps; and the size of the parsed CSV
SM_N, SM_CHUNK, SM_M, SM_ITRS, CSV_MB = 20_000, 5_000, 3, 50, 100
TRACE_ITRS = 5                  # the Adam steps of phase 18's traced selection
# phase 19, the rest of parallel/ on a (1, 1) NCCL mesh: selections of (a) the logistic
# and (b) the multiclass sharded group build after a warm-up, (e) the sharded flow's
# training steps (of SHF_STEPS), (g) selections of the sharded NIW build
PAR_GB_SELECTIONS, PAR_GC_SELECTIONS, PAR_SHF_STEPS, PAR_V_SELECTIONS = 2, 1, 500, 2
# phase 20: the headline build exported with its draws stacked for EXP_STACK selections
# (the headline's M) and run at each of EXP_ITRS selections from that one artifact; the
# multiclass build of phase 6 exported and run at MCX_ITRS selections
EXP_STACK, EXP_ITRS, MCX_ITRS = 100, (2, 3), 2
# and the ported drivers, each once at its defaults cut in depth: fewer selections (--M),
# evaluated sizes and MCMC draws, flow steps and samples (the cuts are printed)
EX_CUTS = {
    "zellner_logreg": ["--M", "10", "--eval-every", "5", "--mcmc-samples", "200",
                       "--mcmc-warmup", "200"],
    "zellner_gaussian": ["--M", "5"],
    "multiclass": ["--M", "4", "--eval-every", "2"],
    "group_selection": ["--M", "3"],
    "poisson_regression": ["--M", "5"],
    "mvn_unknown_cov": ["--M", "5"],
    "zellner_neural_linear": ["--M", "2"],
    "shf_logreg": ["--train-steps", "500", "--chunk", "500", "--n-samples", "400"],
}
# the keys of each JAX driver's results pickle (examples/<name>.py), which the port's
# must carry
EX_KEYS = {
    "zellner_logreg": {"args", "w", "p", "accs", "plls", "build_time_s", "mcmc_times",
                       "mcmc_diagnostics", "full_data", "select_beta"},
    "zellner_gaussian": {"alg", "trial", "w", "p", "rklw", "fklw", "betas", "build_time_s",
                         "select_beta", "mup", "Sigp"},
    "multiclass": {"args", "sizes", "accs", "build_s", "base", "select_beta",
                   "mcmc_escalations"},
    "group_selection": {"args", "order", "accs", "select_time_s", "select_beta"},
    "poisson_regression": {"args", "w", "p", "plls", "build_time_s", "mcmc_times",
                           "mcmc_diagnostics", "select_beta"},
    "mvn_unknown_cov": {"args", "w", "p", "mu_err", "sig_tr", "rkl", "pll", "build_time_s",
                        "select_beta"},
    "zellner_neural_linear": {"args", "rmses", "nlls", "time_s", "select_beta"},
}
# phase 21: the headline mesh driver's selections (K3 OPT_ITRS times each), the raw rows
# of each preprocess file, K1's launches in one entry() iteration (one a step), and the
# rows of bench_native_loader's numpy comparison (of its 126,185: numpy's rate does not
# depend on the size, and writing and parsing the full files took 52 s of the phase)
MESH_ITRS, PRE_ROWS, ENTRY_K1, BNL_ROWS = 3, 400, 10, 20_000
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
    _, Xc5, _, prior5, post5, _, prj5 = gaussian_setup(G_EXAMPLE_N)
    # GIGAO and GIGAR there, as the example builds them, beside the JAX
    # package's record: the draws differ, so only the order of magnitude
    kl5 = {"PRIOR": rkl(torch.zeros(1), torch.zeros((1, G_D)), prior5, post5)}
    for tag in ("GIGAO", "GIGAR"):
        a5 = bc.HilbertCoreset(Xc5, prj5[tag], seed=seed, **on)
        _, t5 = _synced(lambda: a5.snnls.build_trace(G_M))
        a5._sync_state()
        w, p, _ = a5.get()
        kl5[tag] = rkl(w, p, prior5, post5)
        log(f"hilbert, {tag} at the example's N={G_EXAMPLE_N}: build_trace({G_M}) {t5:.3f} s, "
            f"{len(w)} points, reverse KL to the clean posterior {kl5[tag]:.4g} (the JAX "
            f"package's, RESULTS.md:37-38: {H_JAX_RKL[tag]:.2g}); {card}")
        del a5
    log(f"hilbert, the prior's reverse KL at N={G_EXAMPLE_N}: {kl5['PRIOR']:.4g} (RESULTS.md:40 "
        f"records {H_JAX_RKL['PRIOR']:.2g})")
    for tag in ("GIGAO", "GIGAR"):
        if not H_JAX_RKL[tag] / 10 <= kl5[tag] <= H_JAX_RKL[tag] * 10:
            raise AssertionError(f"{tag} at N={G_EXAMPLE_N}: reverse KL {kl5[tag]:.4g} is more "
                                 f"than an order of magnitude off the JAX record "
                                 f"{H_JAX_RKL[tag]:.2g}")
    summary.append(f"N={G_EXAMPLE_N} rKL GIGAO {kl5['GIGAO']:.3g} GIGAR {kl5['GIGAR']:.3g}")
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
        # to about 1e-4; with the re-solve's Gram and right-hand side summed
        # in float64 (snnls/nnls.py) its float32 path keeps float64's columns,
        # as the JAX package's float32 LAR does
        if first64 is not None or first32 is not None:
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
    through the port's loaders (betacores_tpu_torch/data/loaders.py):
    whitened covariates (``std_cov``), the 100 groups of the pickle, each
    group's rows corrupted in proportion to its demographic fraction (half
    the columns replaced by N(0, 10) noise and the label flipped), the test
    set rebalanced and whitened alike. Returns float32 (Z, Xt, Yt) and the
    group lists."""
    from pathlib import Path

    from betacores_tpu_torch.data import load_groups_pickle, load_npz, std_cov

    root = Path(__file__).resolve().parent / "data"
    X, Y, Xt, Yt = load_npz(str(root / "movielens_grouped.npz"))
    X, Y, _, mean, cov = std_cov(X, Y)
    groups, demos = load_groups_pickle(str(root / "vq_groups_sensemake_movielens_grouped.pk"))
    groups = [[k for k in g if k < X.shape[0]] for g in groups]
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
    Xt, Yt, _, _, _ = std_cov(Xt, Yt, mean, cov)
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


def nl_data(seed: int, n: int, d: int):
    """examples/zellner_neural_linear.py's synth data on the host: ``n``
    train and NL_N_TEST test rows of ``gen_synthetic_linreg(D=d)`` from
    ``seed``, standardised on the train rows, the train rows in random
    groups of NL_GROUP with NL_F_RATE of the groups corrupted. Returns
    (Z, Z_init, Z_test (its first 1000 rows), groups, out_mean, out_std),
    float32 [x, y] rows."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.data import make_random_groups, perturb_groups, standardize

    X, Y, _ = bc.gen_synthetic_linreg(torch.Generator().manual_seed(seed), N=n + NL_N_TEST, D=d)
    X, Y = X.numpy(), Y.numpy()
    X, Xt, Y, Yt = X[:n], X[n:], Y[:n], Y[n:]
    Xi, Yi = X[:NL_INIT].copy(), Y[:NL_INIT].copy()
    X, Y, Xi, Yi, Xt, Yt, _, _, out_m, out_s = standardize(X, Y, Xi, Yi, Xt, Yt)
    groups = make_random_groups(np.random.default_rng(seed), n, NL_GROUP)
    X, Y = perturb_groups(seed + 1, X, Y, groups, f_rate=NL_F_RATE)
    f32 = lambda *a: np.hstack(a).astype(np.float32)
    return f32(X, Y), f32(Xi, Yi), f32(Xt, Yt)[:1000], groups, out_m, out_s


def nl_model(Z, Z_init, out_m, out_s, seed: int, dev: str):
    """The example's NeuralLinear and ContextualProjector: prior mean the
    responses' mean, prior precision 1 / (std^2 + mean^2), noise variance
    the responses' variance."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.models import neural_linear as tnl

    mn, sd = float(np.mean(Z[:, -1])), float(np.std(Z[:, -1]))
    sigsq = max(sd ** 2, 1e-3)
    mu0 = mn * torch.ones(NL_F)
    Sig0inv = torch.linalg.inv((sd ** 2 + mn ** 2) * torch.eye(NL_F))
    nl = tnl.NeuralLinear(Z_init, out_features=NL_F, output_mean=out_m, output_std=out_s,
                          sigmasq=sigsq, seed=seed, device=dev)
    prj = bc.coresets.ContextualProjector(
        tnl.neural_linear_sampler_factory(nl.module, mu0, Sig0inv, sigsq), NL_S,
        tnl.neural_linear_model_factory(nl.module, sigsq))
    return nl, prj


def nl_alg(name: str, Z, Z_init, groups, prj, seed: int, on: dict, graph=None):
    """The example's BCORES, SVI or RAND over ``groups``, warm-started from
    the NL_INIT initial rows at indices 10,000,000 + i."""
    import betacores_tpu_torch as bc

    init = dict(wts=np.ones(NL_INIT), idcs=10_000_000 + np.arange(NL_INIT), pts=Z_init)
    kw = dict(opt_itrs=NL_ITRS, n_subsample_opt=NL_N_OPT, step_sched=lambda i: NL_I0 / (1.0 + i),
              seed=seed, groups=groups, initialized=True, graph=graph, **init, **on)
    if name == "BCORES":
        return bc.BetaCoreset(Z, prj, beta=NL_BETA, learn_beta=False, **kw)
    if name == "SVI":
        return bc.SparseVICoreset(Z, prj, **kw)
    return bc.UniformSamplingCoreset(Z, seed=seed, groups=groups, **init, **on)


def nl_train(nl, alg, sync) -> float:
    """The example's round after a build: the encoder conditions on the
    coreset and retrains on it (NL_EPOCHS epochs); returns the seconds."""
    wts, pts = alg.get()[:2]
    nl.update_batch(pts.astype(np.float32))
    t0 = time.perf_counter()
    nl.optimize(wts.astype(np.float32), pts.astype(np.float32), num_epochs=NL_EPOCHS,
                initial_lr=NL_LR, weight_decay=NL_WD)
    sync()
    return time.perf_counter() - t0


def phase_neural_linear(seed: int, card: str, dev: str = "cuda", n_big: int = NLB_N,
                        rounds: int = NL_M) -> str:
    """Phase 16: the neural-linear experiment (examples/zellner_neural_linear.py)
    through the port's contextual builds, float32.

    (a) the example at its defaults: BCORES for ``rounds`` rounds, SVI and
        RAND for NL_CUT_ROUNDS of them, each a build(1, .) under the current
        encoder and a 200-epoch retraining, with the test RMSE and NLL at
        rounds 0, 5, 10, 15, 20;
    (b) scale: ``n_big`` rows at YearPredictionMSD's width (D = 90) in
        groups of 20, 10 % of the groups corrupted, the same widths and
        steps: a contextual group BetaCoreset (select over every group
        through the scatter reduction; the buffer holds every row, as the
        example's does), a warm-up selection and NLB_SELECTIONS more, each
        captured and then again eager (``graph=False``) from the same state
        under the same draws and context, which must select the same groups
        and m with weights within GRAPH_TOL of max|w|; after each the
        encoder retrains, so the later replays run under a new context;
    (c) the card against the CPU: a small contextual group build in float64
        (check_same_build) and one 5-epoch training of each variant from
        one state under one order (the losses and the determined
        parameters within rtol 2e-4, atol 2e-5; the Linear biases and
        running means are driven by rounding, tests/test_torch_neural_linear.py).

    K1, K2 and K3 must launch 0 times in the phase. Returns one summary
    line."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.coresets import FixedDraws, init_group_state
    from betacores_tpu_torch.coresets import make_group_incremental_builder
    from betacores_tpu_torch.models import neural_linear as tnl
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.ops.projection import Groups

    t_phase = time.perf_counter()
    on = {} if dev == "cuda" else {"device": dev}
    sync = torch.cuda.synchronize
    wrappers = (kernels.logreg_adam_step, kernels.multiclass_projection,
                kernels.logreg_shard_step_partials)
    for w in wrappers:
        w.launches = 0
    summary = []

    # --- a. the example at its defaults ---
    data = nl_data(seed, NL_N, NL_D)
    Z, Z_init, Z_test, groups, out_m, out_s = data
    log(f"neural-linear a: synth N={NL_N} x D={NL_D} (+ intercept), {len(groups)} groups of "
        f"{NL_GROUP} ({NL_F_RATE:.0%} corrupted), {NL_INIT} initial rows, {len(Z_test)} test "
        f"rows; F={NL_F}, S={NL_S}, {NL_ITRS} Adam steps on {NL_N_OPT} rows, i0={NL_I0}, "
        f"beta={NL_BETA}, {rounds} rounds, {NL_EPOCHS} epochs a retraining")
    finals = {}
    for name in ("BCORES", "SVI", "RAND"):
        n = rounds if name == "BCORES" else min(rounds, NL_CUT_ROUNDS)
        nl, prj = nl_model(Z, Z_init, out_m, out_s, seed, dev)
        alg = nl_alg(name, Z, Z_init, groups, prj, seed, on)
        nll, rmse = [0.0] * (n + 1), [0.0] * (n + 1)
        nll[0], rmse[0] = nl.test(Z_test)
        t_build = t_train = 0.0
        t_run = time.perf_counter()
        for m in range(1, n + 1):
            if name != "RAND":
                alg.ctx = nl.variables
            t0 = time.perf_counter()
            alg.build(1, NL_N + NL_INIT)
            sync()
            t_build += time.perf_counter() - t0
            t_train += nl_train(nl, alg, sync)
            nll[m], rmse[m] = nl.test(Z_test)
        t_run = time.perf_counter() - t_run
        if not all(math.isfinite(v) for v in nll + rmse):
            raise AssertionError(f"neural-linear {name}: non-finite RMSE or NLL {rmse} {nll}")
        size = len(alg.get()[0])
        if size <= NL_INIT:
            raise AssertionError(f"neural-linear {name}: the coreset did not grow ({size})")
        shown = sorted({m for m in NL_ROUNDS if m <= n} | {n})
        jax = NL_JAX_RMSE.get(name) if n == NL_M else None
        log(f"neural-linear a, {name}: RMSE rounds {shown}: "
            f"{' -> '.join(f'{rmse[m]:.2f}' for m in shown)}; NLL "
            f"{' -> '.join(f'{nll[m]:.3f}' for m in shown)}; {size} points; "
            + (f"the JAX package's trajectory (RESULTS.md:236-238, TPU, its own draws) "
               f"{jax[0]} -> {jax[1]}; " if jax else "")
            + f"{t_run:.1f} s ({t_build:.2f} s building, {t_train:.1f} s training, "
            f"{t_train / n:.3f} s a retraining); {card}")
        finals[name] = rmse[n]
        summary.append(f"{name} RMSE {rmse[0]:.2f}->{rmse[n]:.2f} in {t_run:.1f} s")
        del alg, nl
    log(f"neural-linear a: final RMSE " + ", ".join(f"{k} {v:.2f}" for k, v in finals.items()))

    # --- b. scale: rows at YearPredictionMSD's width ---
    t0 = time.perf_counter()
    Z, Z_init, Z_test, groups, out_m, out_s = nl_data(seed + 1, n_big, NLB_D)
    t_data = time.perf_counter() - t0
    Zd = torch.from_numpy(Z).to(dev)
    nl, prj = nl_model(Z, Z_init, out_m, out_s, seed, dev)
    torch.cuda.reset_peak_memory_stats()
    alg = nl_alg("BCORES", Zd, Z_init, groups, prj, seed, on)
    eager = nl_alg("BCORES", Zd, Z_init, groups, prj, seed, on, graph=False)
    if alg._builder.onehot is not None:
        raise AssertionError("select over every group should take the scatter reduction")
    cap, n_tot = alg.state.wts.shape[0], n_big + NL_INIT
    log(f"neural-linear b: N={n_big} x D={NLB_D} (+ intercept; data made on the host in "
        f"{t_data:.1f} s), {len(groups)} groups of {NL_GROUP}, a {cap}-slot buffer, select "
        f"over every group (scatter reduction); {card}")
    prev, t_sel, t_train = None, [], []
    for i in range(NLB_SELECTIONS + 1):
        ctx = nl.variables
        if prev is not None and all(torch.equal(ctx[k], prev[k]) for k in ctx):
            raise AssertionError("neural-linear b: the retraining left the encoder as it was")
        alg.ctx = eager.ctx = prev = ctx
        eager.state, eager._gstate = alg.state, alg._gstate
        _, t = _synced(lambda: alg.build(1, n_tot))
        eager.build(1, n_tot)
        if alg.selected_groups != eager.selected_groups:
            raise AssertionError(f"neural-linear b: captured groups {alg.selected_groups} != "
                                 f"eager {eager.selected_groups}")
        same = check_graph_equals_eager(f"neural-linear b, selection {i}", alg.state,
                                        eager.state)
        check_state(alg.state)
        t_tr = nl_train(nl, alg, sync)
        nll, rmse = nl.test(Z_test)
        log(f"neural-linear b, {'warm-up' if i == 0 else f'selection {i}'}: {t:.3f} s "
            f"captured; captured == eager ({same}); groups {alg.selected_groups}; "
            f"retraining {t_tr:.3f} s; test RMSE {rmse:.3f}, NLL {nll:.3f}")
        if i > 0:
            t_sel.append(t)
            t_train.append(t_tr)
    # one select and one refinement pass alone, under the last context
    b = alg._builder
    gst = alg._gstate._replace(core=alg.state)
    draws = b.generator_draws(torch.Generator(device=dev).manual_seed(seed))
    b.load_ctx(nl.variables)
    g1, t_select = _synced(lambda: b.select(gst, draws, 0))
    _, t_opt = _synced(lambda: b.optimize(g1, draws, 0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    graphs, t_cap = b.capture_stats()
    log(f"neural-linear b: {1e3 * sum(t_sel) / len(t_sel):.1f} ms a selection "
        f"({', '.join(f'{x:.3f}' for x in t_sel)} s), a select alone {t_select * 1e3:.1f} ms, "
        f"a refinement pass {t_opt:.3f} s ({t_opt / NL_ITRS * 1e6:.1f} us an Adam step), "
        f"{sum(t_train) / len(t_train):.3f} s a retraining (eager), {graphs} graphs captured "
        f"in {t_cap:.2f} s, peak memory {peak:.2f} GiB; {card}")
    summary.append(f"scale {t_opt / NL_ITRS * 1e6:.0f} us/step, {t_select * 1e3:.0f} ms/select")
    del alg, eager, b, gst, g1, Zd, nl, prj
    torch.cuda.empty_cache()

    # --- c. the card against the CPU ---
    rng = np.random.default_rng(seed)
    n_c, d_c = 400, 4
    Xc = rng.normal(size=(n_c, d_c))
    Zc = np.c_[Xc, Xc @ rng.normal(size=d_c) + np.sin(Xc[:, 0]) + 0.1 * rng.normal(size=n_c)]
    gl = [list(range(g * 10, g * 10 + 10)) for g in range(n_c // 10)]
    enc = tnl.Encoder(d_c, 6)
    cfg = bc.IncrementalConfig(projection_dim=16, n_subsample_opt=50, opt_itrs=20, i0=0.1,
                               use_beta=True)
    ctxs = []
    for k in (1, 2):
        e = tnl.Encoder(d_c, 6)
        e.reset_parameters(torch.Generator().manual_seed(seed + k))
        e.norm0.running_mean.uniform_(-0.3, 0.3, generator=torch.Generator().manual_seed(k))
        ctxs.append({n: v.detach().double() for n, v in e.state().items()})
    g = torch.Generator().manual_seed(seed)
    draws = FixedDraws([(torch.randn(16, 6, dtype=torch.float64, generator=g), None)
                        for _ in range(3)],
                       [(torch.randn(20, 16, 6, dtype=torch.float64, generator=g),
                         torch.randint(0, n_c, (20, 50), generator=g)) for _ in range(3)])
    out = {}
    for where in ("cpu", dev):
        bld = make_group_incremental_builder(
            torch.from_numpy(Zc).to(where), Groups.from_lists(gl, where),
            tnl.neural_linear_model_factory(enc, 0.5),
            tnl.neural_linear_sampler_factory(enc, torch.zeros(6, dtype=torch.float64),
                                              torch.eye(6, dtype=torch.float64), 0.5),
            cfg, contextual=True)
        st = init_group_state(bc.init_state(n_c, d_c + 1, beta=0.5, dtype=torch.float64,
                                            device=where), len(gl))
        st = bld.build(st, 3, draws, ctx=ctxs[0])
        out[where] = bld.build(st, 3, draws, ctx=ctxs[1])
    if not torch.equal(out[dev].selected.cpu(), out["cpu"].selected):
        raise AssertionError("neural-linear c: the card selects other groups than the CPU")
    same = check_same_build("neural-linear c, contextual group build", out[dev].core,
                            out["cpu"].core)
    log(f"neural-linear c, contextual group build (float64, 3 + 3 selections, the context "
        f"changed between): card == CPU ({same})")
    Zt = Zc[:64].astype(np.float32)
    wt = rng.uniform(0.5, 3.0, size=64).astype(np.float32)
    perms = np.stack([rng.permutation(64) for _ in range(5)])
    for student_t in (False, True):
        res = {}
        for where in ("cpu", dev):
            m = tnl.NeuralLinear(Zt, out_features=6, sigmasq=0.5, student_t=student_t,
                                 seed=seed, device=where)
            losses = m.optimize(wt, Zt, num_epochs=5, perms=perms)
            res[where] = (losses, tnl.encoder_state_to_numpy(m.variables))
        (l0, s0), (l1, s1) = res["cpu"], res[dev]
        np.testing.assert_allclose(l1, l0, rtol=2e-4, atol=2e-5)
        worst = float(np.abs(l1 - l0).max())
        for i in range(tnl.N_LAYERS):
            pairs = [(s1["params"][f"Dense_{i}"]["kernel"], s0["params"][f"Dense_{i}"]["kernel"]),
                     (s1["batch_stats"][f"BatchNorm_{i}"]["var"],
                      s0["batch_stats"][f"BatchNorm_{i}"]["var"])]
            pairs += [(s1["params"][f"BatchNorm_{i}"][k], s0["params"][f"BatchNorm_{i}"][k])
                      for k in ("scale", "bias")]
            for a, c in pairs:
                np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)
        log(f"neural-linear c, a 5-epoch training ({'Student-t' if student_t else 'Gaussian'}): "
            f"card == CPU (losses within {worst:.2e}; kernels, scales, shifts and running "
            f"variances within rtol 2e-4, atol 2e-5)")

    launched = {w.__name__: w.launches for w in wrappers}
    if any(launched.values()):
        raise AssertionError(f"neural-linear: a kernel launched on a path that has none: "
                             f"{launched}")
    line = (f"neural-linear (phase 16, {time.perf_counter() - t_phase:.1f} s): "
            + "; ".join(summary) + f"; K1/K2/K3 launches {list(launched.values())}")
    return line



def _mcmc_line(tag: str, samples, Xt, yt, Zt, secs: float) -> dict:
    """Accuracy, predictive log-likelihood and diagnostics of one evaluation."""
    from betacores_tpu_torch.evaluation import compute_accuracy, predictive_loglik
    from betacores_tpu_torch.inference import summarize_chains

    flat = samples.reshape(-1, samples.shape[-1])
    summ = summarize_chains(samples)
    row = {"acc": float(compute_accuracy(Xt, yt, flat)), "pll": float(predictive_loglik(Zt, flat)),
           "rhat": float(summ["rhat"].max()), "ess": float(summ["ess"].min()), "s": secs}
    if not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"{tag}: non-finite draws")
    return row


def _nuts_counts() -> collections.Counter:
    """Draws, doublings and host reads of the weighted-logreg NUTS runs so far."""
    from betacores_tpu_torch.inference import nuts

    c = collections.Counter()
    if nuts._LOGREG_NUTS is not None:
        for run, _, _ in nuts._LOGREG_NUTS.runner.cache.values():
            c.update(run.kernel.counts)
    return c


def mcmc_self_check(dev: str) -> None:
    """Phase 17 (e): an HMC and a NUTS run (d = 4, 40 + 40 iterations, 2
    chains) captured against eager under the same draws, bit for bit; both
    on the card against the CPU in float64 to 1e-10; 20 SHF steps on the
    card against the CPU in float64 to 1e-8 (and captured against eager in
    float32, bit for bit)."""
    from betacores_tpu_torch.inference import (HMCConfig, NUTSConfig, SHFConfig, draw_hmc,
                                               draw_nuts, draw_shf, init_shf_params,
                                               make_shf_trainer, run_chains, run_chains_nuts)
    from betacores_tpu_torch.models import logreg

    rng = np.random.default_rng(17)
    X = rng.normal(size=(500, 4))
    y = np.where(rng.uniform(size=500) < 1 / (1 + np.exp(-X.sum(1))), 1.0, -1.0)
    Z0 = torch.from_numpy(y[:, None] * X)
    w0 = torch.from_numpy(rng.uniform(0.5, 2.0, 500))

    def mcmc(sampler, where, dtype, graph):
        Z, w = Z0[:60].to(where, dtype), w0[:60].to(where, dtype)
        lp, th0 = (lambda th: logreg.log_joint(Z, th, w)), torch.zeros(4, dtype=dtype, device=where)
        if sampler == "HMC":
            cfg = HMCConfig(n_samples=40, n_warmup=40, L_max=16)
            draws = draw_hmc(torch.Generator().manual_seed(1), 2, 4, cfg, torch.float64)
            return run_chains(draws, lp, th0, 2, cfg, graph=graph)
        cfg = NUTSConfig(n_samples=40, n_warmup=40, max_treedepth=8)
        draws = draw_nuts(torch.Generator().manual_seed(1), 2, 4, cfg, torch.float64)
        return run_chains_nuts(draws, lp, th0, 2, cfg, graph=graph)

    for sampler in ("HMC", "NUTS"):
        a = mcmc(sampler, dev, torch.float32, None)
        b = mcmc(sampler, dev, torch.float32, False)
        if not (torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k]) for k in a[1])):
            raise AssertionError(f"{sampler}: the captured run differs from the eager one")
        c = mcmc(sampler, dev, torch.float64, None)
        d = mcmc(sampler, "cpu", torch.float64, None)
        gap = max(float((c[0].cpu() - d[0]).abs().max()),
                  *(float((c[1][k].cpu() - d[1][k]).abs().max()) for k in d[1]))
        if not gap <= 1e-10:
            raise AssertionError(f"{sampler}: the card's float64 run is {gap:.3e} off the CPU's")
        log(f"mcmc e, {sampler} (d = 4, 40 + 40 iterations, 2 chains): captured == eager bit "
            f"for bit in float32; card == CPU in float64 within {gap:.2e} (limit 1e-10)")
    cfg = SHFConfig(n_blocks=2, n_leapfrog=3, n_mc=4, n_batch=32)
    draws = draw_shf(torch.Generator().manual_seed(2), 20, 500, 4, cfg, torch.float64)
    out = {}
    for where, dtype, graph in ((dev, torch.float32, None), (dev, torch.float32, False),
                                (dev, torch.float64, None), ("cpu", torch.float64, None)):
        Zd = Z0.to(where, dtype)
        train = make_shf_trainer(Zd, logreg.log_joint, cfg, graph=graph)
        out[(where, dtype, graph)] = train(draws, init_shf_params(Zd[:10], 4, 500, cfg), 20)
    a, b = out[(dev, torch.float32, None)], out[(dev, torch.float32, False)]
    if not (torch.equal(a[1], b[1]) and all(torch.equal(x, y) for x, y in zip(a[0], b[0]))):
        raise AssertionError("SHF: the captured training differs from the eager one")
    c, d = out[(dev, torch.float64, None)], out[("cpu", torch.float64, None)]
    gap = max(float((x.cpu() - y).abs().max()) for x, y in zip((c[1], *c[0]), (d[1], *d[0])))
    if not gap <= 1e-8:
        raise AssertionError(f"SHF: the card's float64 training is {gap:.3e} off the CPU's")
    log(f"mcmc e, SHF (20 Adam steps): captured == eager bit for bit in float32; card == CPU "
        f"in float64 within {gap:.2e} (limit 1e-8)")


def phase_mcmc_eval(seed: int, card: str, dev: str = "cuda") -> dict:
    """Phase 17: the paper's main experiment end to end through the port's
    MCMC evaluation, and the sparse Hamiltonian flows, float32.

    (a) examples/zellner_logreg.py at its defaults: synth_lr (N = 12,000, d
        = 10, 2000 test rows), 10 % corrupted, a BetaCoreset (beta 0.1, the
        Laplace sampler, S = 100, 500 Adam steps on 200 rows, a 1000-row
        select) built by build_trace(100), every Adam step through K1; each
        tenth size padded with zeros to one capacity and evaluated by 2 HMC
        chains of 1000 + 1000 iterations (L_max = 32) through
        run_with_escalation, NUTS at default_nuts_config(1000, 1000); the
        accuracy and predictive log-likelihood, R-hat, ESS, acceptance and
        seconds per size. Raises unless the accuracy at m = 100 is above
        m = 0's and every recorded R-hat is finite;
    (b) --eval-sampler nuts at m = 100 (mean tree depth, leapfrog steps,
        doublings and host reads per draw, divergences) and
        --eval-full-data (HMC on a 5000-row subsample, weights N/n);
    (c) an escalation by itself: tests/test_inference.py's ill-conditioned
        target (d = 6, axis sds logspace(-2, 1), 4 chains), HMC at L_max =
        16 first; raises unless NUTS was recorded with R-hat < 1.02 and
        every marginal sd within 10 %;
    (d) examples/shf_logreg.py at its defaults: the flow (N = 20,000, d = 5,
        M = 30, 4 blocks x 8 leapfrog steps, n_mc 8, B 256, 6000 Adam steps
        in chunks of 2000, 2000 samples) and its baseline, 2 HMC chains of
        1000 + 1000 on every row;
    (e) ``mcmc_self_check``.
    Returns K1's launches in (a)'s build, the m = 100 coreset (points and
    weights, padded, on the card) and one summary line."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch import gen_synthetic_logreg, logreg, logreg_laplace_sampler, perturb_logreg
    from betacores_tpu_torch.evaluation import compute_accuracy, predictive_loglik
    from betacores_tpu_torch.inference import (HMCConfig, NUTSConfig, SHFConfig,
                                               default_nuts_config, init_shf_params,
                                               make_shf_trainer, run_chains, run_chains_nuts,
                                               run_chains_weighted_logreg,
                                               run_chains_weighted_logreg_nuts,
                                               run_with_escalation, shf_sample, summarize_chains)
    from betacores_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    on = {} if dev == "cuda" else {"device": dev}
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    keyed = lambda s: torch.Generator(device=dev).manual_seed(s)
    summary = []

    # --- (a) the main experiment: the build, then HMC at every ZL_CUT_EVERY-th size ---
    gen = keyed(seed + 17)
    X, y, _ = gen_synthetic_logreg(gen, ZL_N, d=ZL_D)
    Xt, yt, Zt = gen_synthetic_logreg(gen, ZL_N_TEST, d=ZL_D)
    X, y, Z, out = perturb_logreg(gen, X, y, f_rate=ZL_F_RATE)
    prj = bc.BetaBlackBoxProjector(logreg_laplace_sampler(), ZL_S, model=logreg.bundle())
    alg = bc.BetaCoreset(Z, prj, beta=ZL_BETA, learn_beta=False, opt_itrs=ZL_ITRS,
                         n_subsample_opt=ZL_N_OPT, n_subsample_select=ZL_N_SEL,
                         step_sched=lambda i: ZL_I0 / (1.0 + i), seed=ZL_TRIAL, max_size=ZL_M,
                         **on)
    kernels.logreg_adam_step.launches = 0
    sync()
    t0 = time.perf_counter()
    trace = alg.build_trace(ZL_M)
    sync()
    t_build = time.perf_counter() - t0
    k1 = kernels.logreg_adam_step.launches
    if dev == "cuda" and k1 != ZL_M * ZL_ITRS:
        raise AssertionError(f"mcmc a: K1 launched {k1} times in the build, want {ZL_M * ZL_ITRS}")
    log(f"mcmc a, data: synth_lr N={ZL_N} x d={ZL_D}, {len(out)} corrupted rows, {ZL_N_TEST} "
        f"test rows; BetaCoreset build_trace({ZL_M}) {t_build:.3f} s "
        f"({t_build / ZL_M:.3f} s per selection), K1 launches {k1}; {card}")
    w = [np.zeros(1)] + [np.atleast_1d(t[0]) for t in trace]
    p = [np.zeros((1, ZL_D))] + [np.atleast_2d(t[1]) for t in trace]
    eval_ms = sorted(set(range(0, ZL_M + 1, ZL_CUT_EVERY)) | {ZL_M})
    cap = max(len(w[m]) for m in eval_ms)

    def padded(m):
        wm = np.pad(w[m].astype(np.float32), (0, cap - len(w[m])))
        pm = np.pad(p[m].astype(np.float32), ((0, cap - len(w[m])), (0, 0)))
        return torch.from_numpy(pm).to(dev), torch.from_numpy(wm).to(dev)

    cfg = HMCConfig(n_samples=ZL_SAMPLES, n_warmup=ZL_WARMUP, L_max=ZL_L_MAX)
    nuts_cfg = default_nuts_config(ZL_SAMPLES, ZL_WARMUP)
    theta0 = torch.zeros(ZL_D, device=dev)
    rows, hmc_secs = {}, []
    for m in eval_ms:
        pm, wm = padded(m)
        c0 = _nuts_counts()
        sync()
        t1 = time.perf_counter()
        run = run_with_escalation(keyed(ZL_TRIAL * 100 + m), run_chains_weighted_logreg, cfg,
                                  run_chains_weighted_logreg_nuts, nuts_cfg, pm, wm, theta0,
                                  ZL_CHAINS, primary_name="hmc")
        sync()
        secs = time.perf_counter() - t1
        row = _mcmc_line(f"m={m}", run.chains, Xt, yt, Zt, secs)
        row.update(sampler=run.sampler_used, accept=float(run.stats["accept_stat"].mean()))
        rows[m] = row
        extra = ""
        if run.escalated:
            c = _nuts_counts() - c0
            extra = (f"  ** hmc failed ({run.failure_reason}); recorded the NUTS re-run: mean "
                     f"tree depth {float(run.stats['mean_treedepth'].mean()):.2f}, "
                     f"{float(run.stats['mean_leapfrog'].mean()):.1f} leapfrog steps and "
                     f"{c['doublings'] / max(c['draws'], 1):.2f} doublings per draw")
        elif m != eval_ms[0]:
            hmc_secs.append(secs)
        log(f"mcmc a, m={m:3d} ({len(w[m])} points, capacity {cap}): acc={row['acc']:.4f} "
            f"pll={row['pll']:.4f} accept={row['accept']:.2f} rhat={row['rhat']:.3f} "
            f"ess={row['ess']:.0f} [{row['sampler']}] {secs:.3f} s{extra}")
    per_it = (np.median(hmc_secs) / (ZL_WARMUP + ZL_SAMPLES) * 1e6) if hmc_secs else float("nan")
    log(f"mcmc a: m=0 accuracy {rows[0]['acc']:.4f}, m={ZL_M} {rows[ZL_M]['acc']:.4f}; the JAX "
        f"package's record at m={ZL_M} (RESULTS.md:440-442, BCORES on synth_lr at 10 % "
        f"corruption, a TPU, its own data and draws) {ZL_JAX_ACC_M100[0]}-{ZL_JAX_ACC_M100[1]}, "
        f"m=0 not recorded (the prior: about 0.5); an HMC size after the first "
        f"{np.median(hmc_secs) if hmc_secs else float('nan'):.3f} s (median), "
        f"{per_it:.1f} us per iteration of 2 chains x L_max={ZL_L_MAX}; the first size "
        f"{rows[eval_ms[0]]['s']:.3f} s (its graphs' capture included); {card}")
    if not rows[ZL_M]["acc"] > rows[0]["acc"]:
        raise AssertionError(f"mcmc a: accuracy at m={ZL_M} ({rows[ZL_M]['acc']:.4f}) is not "
                             f"above m=0's ({rows[0]['acc']:.4f})")
    if not all(math.isfinite(r["rhat"]) for r in rows.values()):
        raise AssertionError(f"mcmc a: a recorded R-hat is not finite: "
                             f"{ {m: r['rhat'] for m, r in rows.items()} }")
    summary.append(f"build {t_build:.1f} s, HMC {per_it:.0f} us/it")

    # --- (b) --eval-sampler nuts at m = 100, and --eval-full-data ---
    pm, wm = padded(ZL_M)
    c0 = _nuts_counts()
    sync()
    t1 = time.perf_counter()
    chains, stats = run_chains_weighted_logreg_nuts(keyed(ZL_TRIAL * 100 + ZL_M), pm, wm, theta0,
                                                    ZL_CHAINS, nuts_cfg)
    sync()
    secs = time.perf_counter() - t1
    c = _nuts_counts() - c0
    row = _mcmc_line("nuts", chains, Xt, yt, Zt, secs)
    depth, leap = float(stats["mean_treedepth"].mean()), float(stats["mean_leapfrog"].mean())
    log(f"mcmc b, --eval-sampler nuts at m={ZL_M}: acc={row['acc']:.4f} pll={row['pll']:.4f} "
        f"rhat={row['rhat']:.3f} ess={row['ess']:.0f}; mean tree depth {depth:.2f}, {leap:.2f} "
        f"leapfrog steps per draw, {c['doublings'] / c['draws']:.2f} doublings (graphs) and "
        f"{c['host_reads'] / c['draws']:.2f} host reads per draw over {c['draws']} draws, "
        f"{int(stats['n_divergent'].sum())} divergences; {secs:.3f} s "
        f"({secs / c['draws'] * 1e6:.0f} us per draw of {ZL_CHAINS} chains); {card}")
    summary.append(f"NUTS {secs:.1f} s ({leap:.1f} steps/draw)")
    N = Z.shape[0]
    n_fd = min(ZL_FULL_CAP, N)
    sub = torch.from_numpy(np.random.default_rng(ZL_TRIAL).choice(N, n_fd, replace=False)).to(dev)
    sync()
    t1 = time.perf_counter()
    chains, stats = run_chains_weighted_logreg(
        keyed(ZL_TRIAL * 100 + 999), Z[sub], torch.full((n_fd,), N / n_fd, device=dev), theta0,
        ZL_CHAINS, cfg)
    sync()
    secs = time.perf_counter() - t1
    row = _mcmc_line("full data", chains, Xt, yt, Zt, secs)
    log(f"mcmc b, --eval-full-data (HMC on {n_fd} rows, weights N/n): acc={row['acc']:.4f} "
        f"pll={row['pll']:.4f} rhat={row['rhat']:.3f} ess={row['ess']:.0f}; {secs:.3f} s "
        f"(first run at this shape, its capture included); {card}")
    del alg, trace, X, y, Z

    # --- (c) an escalation that happens by itself ---
    sd = torch.from_numpy(np.logspace(-2, 1, ESC_D)).float().to(dev)
    target = lambda th: -0.5 * torch.sum((th / sd) ** 2, dim=-1)
    zero = torch.zeros(ESC_D, device=dev)
    sync()
    t1 = time.perf_counter()
    run = run_with_escalation(
        keyed(seed + 170), lambda k, c: run_chains(k, target, zero, ESC_CHAINS, c),
        HMCConfig(n_samples=ESC_SAMPLES, n_warmup=ESC_WARMUP, L_max=ESC_L_MAX),
        lambda k, c: run_chains_nuts(k, target, zero, ESC_CHAINS, c),
        NUTSConfig(n_samples=ESC_SAMPLES, n_warmup=ESC_WARMUP, max_treedepth=10))
    sync()
    secs = time.perf_counter() - t1
    ratio = (run.chains.reshape(-1, ESC_D).std(dim=0) / sd).cpu().numpy()
    rhat = float(run.summary["rhat"].max())
    log(f"mcmc c, escalation: recorded {run.sampler_used} (escalated {run.escalated}; the HMC "
        f"primary at L_max={ESC_L_MAX}: {run.failure_reason or 'passed'}); R-hat {rhat:.4f}, min "
        f"ESS {float(run.summary['ess'].min()):.0f}, marginal sd / true sd "
        f"{np.round(ratio, 3).tolist()}; NUTS mean tree depth "
        f"{float(run.stats.get('mean_treedepth', torch.zeros(1)).mean()):.2f}; {secs:.3f} s "
        f"for both runs; {card}")
    if not (run.sampler_used == "nuts" and rhat < 1.02 and np.abs(ratio - 1.0).max() <= 0.1):
        raise AssertionError(f"mcmc c: want NUTS recorded with R-hat < 1.02 and every marginal "
                             f"sd within 10 %, got {run.sampler_used}, {rhat:.4f}, {ratio}")
    summary.append(f"escalation {secs:.1f} s")

    # --- (d) examples/shf_logreg.py at its defaults ---
    gen = keyed(seed + 171)
    _, _, Zs = gen_synthetic_logreg(gen, SHF_N, d=SHF_D)
    Xs_t, ys_t, Zs_t = gen_synthetic_logreg(gen, ZL_N_TEST, d=SHF_D)
    scfg = SHFConfig(n_blocks=SHF_BLOCKS, n_leapfrog=SHF_LEAP, n_mc=SHF_MC, n_batch=SHF_B,
                     learning_rate=SHF_LR)
    params = init_shf_params(Zs[:SHF_M], SHF_D, SHF_N, scfg)
    train = make_shf_trainer(Zs, logreg.log_joint, scfg)
    chunk_s, elbo = [], []
    for i in range(SHF_STEPS // SHF_CHUNK):
        sync()
        t1 = time.perf_counter()
        params, tr = train(keyed(100 + i), params, SHF_CHUNK)
        sync()
        chunk_s.append(time.perf_counter() - t1)
        elbo.append(tr)
    t_train = sum(chunk_s)
    tr = torch.cat(elbo)
    t1 = time.perf_counter()
    th_f, _, logq = shf_sample(keyed(7), params, logreg.log_joint, SHF_SAMPLES, scfg)
    sync()
    t_sample = time.perf_counter() - t1
    if not (bool(torch.isfinite(th_f).all()) and bool(torch.isfinite(tr).all())
            and float(tr[-20:].mean()) > float(tr[:20].mean())):
        raise AssertionError("mcmc d: the flow's samples or ELBO are not finite, or the ELBO "
                             "did not rise")
    acc_f = float(compute_accuracy(Xs_t, ys_t, th_f))
    pll_f = float(predictive_loglik(Zs_t, th_f))
    step_us = min(chunk_s[1:] or chunk_s) / SHF_CHUNK * 1e6
    log(f"mcmc d, SHF: {SHF_STEPS} Adam steps {t_train:.3f} s (chunks {[round(s, 3) for s in chunk_s]} "
        f"s; {step_us:.1f} us per captured step, a double backward), {SHF_SAMPLES} i.i.d. "
        f"samples {t_sample:.3f} s; acc={acc_f:.4f} pll={pll_f:.4f} coreset nnz "
        f"{int((params.w > 0).sum())}, ELBO {float(tr[:20].mean()):.1f} -> "
        f"{float(tr[-20:].mean()):.1f}; {card}")
    sync()
    t1 = time.perf_counter()
    chains, stats = run_chains_weighted_logreg(
        keyed(ZL_TRIAL * 7), Zs, torch.ones(SHF_N, device=dev), torch.zeros(SHF_D, device=dev),
        2, HMCConfig(n_samples=SHF_SAMPLES // 2, n_warmup=1000, L_max=32))
    sync()
    secs = time.perf_counter() - t1
    row = _mcmc_line("shf baseline", chains, Xs_t, ys_t, Zs_t, secs)
    log(f"mcmc d, the HMC baseline on all {SHF_N} rows (2 chains, 1000 + {SHF_SAMPLES // 2}): "
        f"acc={row['acc']:.4f} pll={row['pll']:.4f} rhat={row['rhat']:.3f} "
        f"ess={row['ess']:.0f}; {secs:.3f} s; flow vs HMC accuracy {acc_f:.4f} / "
        f"{row['acc']:.4f} beside the JAX record {SHF_JAX_ACC[0]} / {SHF_JAX_ACC[1]} "
        f"(RESULTS.md:494-497, a TPU, other draws); {card}")
    summary.append(f"SHF {t_train:.1f} s ({step_us:.0f} us/step)")
    del Zs, train

    # --- (e) self-checks ---
    mcmc_self_check(dev)
    return {"K1": k1, "coreset": padded(ZL_M),
            "line": f"mcmc (phase 17, {time.perf_counter() - t_phase:.1f} s): "
                    + "; ".join(summary)}


def _same_bits(what: str, got, want) -> None:
    """Raises unless two ``merge_reduce_build`` results (state, leaf_pts,
    leaf_wts) agree bit for bit."""
    names = ("wts", "idcs", "pts", "m", "beta", "sampler_aux", "leaf_pts", "leaf_wts")
    for name, a, b in zip(names, (*got[0], got[1], got[2]), (*want[0], want[1], want[2])):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"streaming {what}: {name} differs")


def phase_streaming(seed: int, card: str, dev: str = "cuda", oc_n: int = OC_N,
                    oc_chunk: int = OC_CHUNK, csv_mb: int = CSV_MB) -> dict:
    """Phase 18: the streamed merge-reduce build (coresets/streaming.py)
    with its checkpoints, the host loaders' native parser and the coreset
    checkpoints and timing utilities, float32.

    (a) the ported examples/streaming_build.py (``main(argv)``) at its
        widths: N = 200,000 contaminated logistic rows (d = 10, 10 %
        corrupted) made on the card chunk by chunk and kept on the host, 4
        leaves of 50,000 rows (64-slot buffer, S = 100, 1000-row select, 300
        Adam steps on 200 rows, beta 0.1) streamed through one builder, then
        the weighted final build over the 256-row union (every row, 500 Adam
        steps), with --m-leaf SB_CUT_LEAF and --m-final SB_CUT_FINAL; raises
        unless the coreset's held-out accuracy beats the prior's, and unless
        the driver's ``--parallel-leaves`` (with --m-final 0) gives the same
        leaf union bits;
    (b) the ported examples/streaming_outofcore.py --n 20_000_000 --chunk
        5_000_000 (Gaussian, d = 10, 800 MB of host data in 4 chunks,
        ``--checkpoint``: one a leaf) with --m-leaf = --m-final = OC_CUT_M
        and --n-single 0; raises unless the peak device memory of the driver
        stays below two chunks' bytes plus the builder's pass buffers, the
        checkpoint is gone, and the reverse KL to the exact full-data
        posterior is below the prior's;
    (c) a crash after 2 of 4 leaves and the rerun from the checkpoint, bit
        for bit the uninterrupted build (SM_* depth), checkpoint removed;
    (d) the mesh leaf pass on a (1, 1) mesh (NCCL, a world of one): the
        streamed build's bits, with one all_gather a leaf;
    (e) the native CSV parser (native/loader.cpp, built with g++) against
        the numpy parse of a CSV_MB MB file: equal arrays, and both rates
        (host rates);
    (f) ``save_state``/``load_state`` between two halves of a build on the
        card: the uninterrupted build's bits;
    (g) every section timed with ``Timings`` (saved under chiprun_out/
        as phase18_*), and one ``trace`` of a selection of TRACE_ITRS
        eager Adam steps written there;
    (h) K1, K2 and K3 launch 0 times in the phase.
    Returns the numbers and one summary line."""
    import io
    import os
    import tempfile
    from pathlib import Path

    from betacores_tpu_torch.coresets import (IncrementalConfig, init_state,
                                             make_incremental_builder, merge_reduce_build)
    from betacores_tpu_torch.data import native_loader
    from betacores_tpu_torch.inference import logreg_laplace_sampler
    from betacores_tpu_torch.models import logreg
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.parallel import make_mesh, world_of_one
    from betacores_tpu_torch.utils import Timings, annotate, load_state, save_state, trace

    class CrashAfter(Timings):
        """Timings whose leaf section after the n-th raises: a crash."""

        def __init__(self, n: int):
            super().__init__()
            self.n = n

        def section(self, name: str, sync: bool = True):
            if name == "leaf" and len(self.sections.get("leaf", [])) == self.n:
                raise RuntimeError("simulated crash")
            return super().section(name, sync)

    t_phase = time.perf_counter()
    wrappers = (kernels.logreg_adam_step, kernels.multiclass_projection,
                kernels.logreg_shard_step_partials)
    for w in wrappers:
        w.launches = 0
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    keyed = lambda s: torch.Generator(device=dev).manual_seed(s)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    res = {}
    tmp = tempfile.TemporaryDirectory()

    # --- (a) the ported examples/streaming_build.py at the cut ---
    from betacores_tpu_torch.examples import streaming_build, streaming_outofcore

    sb_argv = ["--N", str(SB_N), "--d", str(SB_D), "--chunk-size", str(SB_CHUNK),
               "--m-leaf", str(SB_CUT_LEAF), "--m-final", str(SB_CUT_FINAL),
               "--m-buf", str(SB_M_BUF), "--proj-dim", str(SB_S), "--opt-itrs", str(SB_ITRS),
               "--device", dev, "--seed", str(seed)]
    log(f"streaming a: python -m betacores_tpu_torch.examples.streaming_build "
        f"{' '.join(sb_argv)} (its defaults otherwise)")
    t0 = time.perf_counter()
    sb = streaming_build.main(sb_argv)
    t_sb = time.perf_counter() - t0
    st_f, lp, lw, tm, host = sb["state"], sb["leaf_pts"], sb["leaf_wts"], sb["timings"], sb["rows"]
    w_f, m_f = check_state(st_f)
    acc, acc_prior = sb["acc"], sb["acc_prior"]
    if not acc > acc_prior:
        raise AssertionError(f"streaming a: the coreset's accuracy {acc:.4f} does not beat the "
                             f"prior's {acc_prior:.4f}")
    # the batched leaf pass: the same leaves in turn (a final build of 0 selections)
    par = streaming_build.main(sb_argv + ["--parallel-leaves", "--m-final", "0"])
    if not (torch.equal(par["leaf_pts"], lp) and torch.equal(par["leaf_wts"], lw)):
        raise AssertionError("streaming a: parallel_leaves differs from the streamed pass")
    del par
    leaf_s = tm.sections["leaf"]
    res.update(leaf_s=leaf_s, final_s=tm.sections["final"][0], acc=acc, acc_prior=acc_prior)
    log(f"streaming a, streaming_build: {SB_N} rows (d={SB_D}, {SB_F_RATE:.0%} corrupted) in "
        f"{len(leaf_s)} leaves of {SB_CHUNK} rows x {SB_CUT_LEAF} selections (of --m-leaf "
        f"{SB_M_LEAF}; {SB_ITRS} Adam steps, {SB_M_BUF}-slot buffer), then the weighted final "
        f"build over the {lw.shape[0]}-row union for {SB_CUT_FINAL} selections (of --m-final "
        f"{SB_M_FINAL}; {max(SB_ITRS, SB_FINAL_ITRS)} eager full-data Adam steps): the driver "
        f"{t_sb:.3f} s, the build {sb['t_stream']:.3f} s; s per leaf "
        f"{[round(t, 4) for t in leaf_s]}, {leaf_s[-1] / SB_CUT_LEAF:.4f} s a leaf selection "
        f"after the first leaf; final build {res['final_s']:.3f} s "
        f"({res['final_s'] / SB_CUT_FINAL:.3f} s a selection); m={m_f}; held-out accuracy "
        f"{acc:.4f} (prior {acc_prior:.4f}); --parallel-leaves == streamed bit for bit; {card}")

    # --- (b) the ported examples/streaming_outofcore.py --n 20_000_000 --chunk 5_000_000 ---
    ckpt = os.path.join(tmp.name, "outofcore.npz")
    oc_argv = ["--n", str(oc_n), "--chunk", str(oc_chunk), "--m-leaf", str(OC_CUT_M),
               "--m-final", str(OC_CUT_M), "--n-single", "0", "--checkpoint", ckpt,
               "--opt-itrs", str(OC_ITRS), "--seed", str(seed + 1), "--device", dev]
    log(f"streaming b: python -m betacores_tpu_torch.examples.streaming_outofcore "
        f"{' '.join(oc_argv)} (its defaults otherwise)")
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    oc = streaming_outofcore.main(oc_argv)
    sync()
    t_oc = time.perf_counter() - t0
    tm_oc = oc["timings"]
    if os.path.exists(ckpt):
        raise AssertionError("streaming b: the checkpoint outlived the build")
    chunk_bytes = oc_chunk * (OC_D + 1) * 4                # rows and row weights
    # the composed pass's static rows (the buffer appended), noise and row weights,
    # and one pass's draws (noise, int64 row indices)
    pass_bytes = OC_ITRS * (4 * ((OC_N_OPT + OC_CUT_M) * OC_D + 2 * OC_S * OC_D + OC_N_OPT)
                            + 8 * OC_N_OPT)
    peak = None
    if dev == "cuda":
        peak = torch.cuda.max_memory_allocated() - base
        if not peak < 2 * chunk_bytes + pass_bytes:
            raise AssertionError(f"streaming b: peak device memory {peak} B is not below two "
                                 f"chunks ({2 * chunk_bytes} B) plus the pass buffers "
                                 f"({pass_bytes} B)")
    rkl, rkl_prior = oc["rkl_stream"], oc["rkl_prior"]
    if not (math.isfinite(rkl) and rkl < rkl_prior):
        raise AssertionError(f"streaming b: reverse KL {rkl:.4g} is not below the prior's "
                             f"{rkl_prior:.4g}")
    ck_s = tm_oc.sections["checkpoint"]
    res.update(oc_leaf_s=tm_oc.sections["leaf"], oc_final_s=tm_oc.sections["final"][0],
               peak=peak, chunk_bytes=chunk_bytes, ckpt_s=ck_s, rkl=rkl, rkl_prior=rkl_prior)
    peak_txt = ("not measured" if peak is None else
                f"{peak / 2**20:.1f} MiB against one chunk's {chunk_bytes / 2**20:.1f} MiB "
                f"(limit {(2 * chunk_bytes + pass_bytes) / 2**20:.1f} MiB)")
    log(f"streaming b, streaming_outofcore --n {oc_n} --chunk {oc_chunk}: "
        f"{oc_n * OC_D * 4 / 1e6:.0f} MB of host data (made in {oc['t_generate_s']} s) in "
        f"{len(tm_oc.sections['leaf'])} leaves, {OC_CUT_M} selections a build (of --m-leaf "
        f"{OC_M}), a checkpoint a leaf: the driver {t_oc:.3f} s; s per leaf "
        f"{[round(t, 4) for t in tm_oc.sections['leaf']]}; final {res['oc_final_s']:.3f} s; "
        f"checkpoint (host copy + atomic npz) ms per leaf {[round(1e3 * t, 3) for t in ck_s]}; "
        f"peak device memory {peak_txt}; nnz {oc['nnz_stream']}; reverse KL to the exact "
        f"{oc_n}-row posterior {rkl:.4g} (prior {rkl_prior:.4g}); {card}")
    del oc

    # --- (c) a crash and the resume, (d) the mesh pass, at a small depth ---
    small = host[:SM_N]
    lr = dict(model=logreg.bundle(), sampler=logreg_laplace_sampler(), device=dev)
    st_leaf = init_state(SB_M_BUF, SB_D, beta=SB_BETA, device=dev)
    sm_cfg = IncrementalConfig(projection_dim=SB_S, n_subsample_select=SB_N_SEL,
                               n_subsample_opt=SB_N_OPT, opt_itrs=SM_ITRS, i0=1.0, use_beta=True)
    sm = dict(leaf_config=sm_cfg, final_config=sm_cfg, chunk_size=SM_CHUNK, m_leaf=SM_M,
              m_final=SM_M, st_leaf=st_leaf, model=lr["model"], sampler=lr["sampler"])
    ref = merge_reduce_build(seed, small, device=dev, **sm)
    ck = os.path.join(tmp.name, "resume.npz")
    try:
        merge_reduce_build(seed, small, device=dev, checkpoint_path=ck, timings=CrashAfter(2),
                           **sm)
        raise AssertionError("streaming c: the simulated crash did not happen")
    except RuntimeError as e:
        if "simulated crash" not in str(e):
            raise
    with np.load(ck) as z:
        if int(z["n_done"]) != 2:
            raise AssertionError(f"streaming c: the checkpoint holds {int(z['n_done'])} leaves")
    _same_bits("c, the resumed build", merge_reduce_build(seed, small, device=dev,
                                                          checkpoint_path=ck, **sm), ref)
    if os.path.exists(ck):
        raise AssertionError("streaming c: the checkpoint outlived the resumed build")
    with world_of_one("nccl" if dev == "cuda" else "gloo"):
        mesh = make_mesh(1, 1)
        got = merge_reduce_build(seed, small, mesh=mesh, **sm)
        gathers = mesh.calls["all_gather"]
    _same_bits("d, the mesh leaf pass", got, ref)
    if gathers != -(-SM_N // SM_CHUNK):
        raise AssertionError(f"streaming d: {gathers} all_gathers for {SM_N // SM_CHUNK} leaves")
    log(f"streaming c-d: {SM_N // SM_CHUNK} leaves of {SM_CHUNK} rows x {SM_M} selections "
        f"({SM_ITRS} Adam steps): a crash after 2 leaves resumed from its checkpoint == the "
        f"uninterrupted build bit for bit (checkpoint removed); the (1, 1) mesh's leaf pass "
        f"({gathers} all_gathers) == the streamed one bit for bit")

    # --- (e) the native CSV parser against numpy ---
    blk = io.StringIO()
    np.savetxt(blk, np.random.default_rng(seed).normal(size=(20_000, 10)).astype(np.float32),
               delimiter=",", fmt="%.7g")
    text = blk.getvalue()
    reps = -(-csv_mb * 1_000_000 // len(text))
    csv = os.path.join(tmp.name, "big.csv")
    with open(csv, "w") as f:
        for _ in range(reps):
            f.write(text)
    mb = os.path.getsize(csv) / 1e6
    t0 = time.perf_counter()
    if not native_loader.native_available():
        raise AssertionError("streaming e: no C++ compiler for the native parser")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = native_loader.load_csv(csv)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = native_loader._csv_numpy(csv)
    t_numpy = time.perf_counter() - t0
    if a.shape != (reps * 20_000, 10) or not np.array_equal(a, b):
        raise AssertionError("streaming e: the native parse differs from the numpy parse")
    res.update(csv_mb=mb, native_mbs=mb / t_native, numpy_mbs=mb / t_numpy)
    log(f"streaming e, a {mb:.1f} MB CSV ({a.shape[0]} x {a.shape[1]}): the native parser "
        f"(built in {t_build:.2f} s) {res['native_mbs']:.1f} MB/s against the numpy parse "
        f"(np.genfromtxt) {res['numpy_mbs']:.1f} MB/s, equal arrays; host rates on this "
        f"machine's CPU ({os.cpu_count()} cores)")
    del a, b

    # --- (f) a build saved and continued, (g) its trace ---
    Zs = torch.from_numpy(small[:SM_CHUNK]).to(dev)
    ones = torch.ones(SM_CHUNK, device=dev)
    bld = make_incremental_builder(Zs, lr["model"], lr["sampler"], sm_cfg, data_weights=ones)
    want = bld.build(st_leaf, 2 * SM_M, bld.generator_draws(keyed(seed + 7)))
    g = keyed(seed + 7)
    half = bld.build(st_leaf, SM_M, bld.generator_draws(g))
    path = os.path.join(tmp.name, "half.pt")
    save_state(path, half, g, {"done": SM_M})
    st_h, g2, extra = load_state(path, device=dev)
    got = bld.build(st_h, 2 * SM_M - extra["done"], bld.generator_draws(g2))
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            raise AssertionError("streaming f: the saved and continued build differs")
    # one selection of TRACE_ITRS eager Adam steps (a new builder's first pass), traced
    short = make_incremental_builder(Zs, lr["model"], lr["sampler"],
                                     dataclasses.replace(sm_cfg, opt_itrs=TRACE_ITRS),
                                     data_weights=ones)
    trace_dir = out_dir / "phase18_trace"
    with trace(str(trace_dir)) as prof:
        with annotate("phase18.one_selection"):
            short.build(st_leaf, 1, short.generator_draws(keyed(seed + 8)))
            sync()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
    trace_mb = sum(f.stat().st_size for f in trace_dir.iterdir()) / 1e6
    tm.save(str(out_dir / "phase18_streaming_build"))
    tm_oc.save(str(out_dir / "phase18_outofcore"))
    log(f"streaming f-g: {SM_M} selections, save_state/load_state, {SM_M} more == "
        f"{2 * SM_M} uninterrupted, bit for bit; one selection of {TRACE_ITRS} eager steps "
        f"traced into chiprun_out/phase18_trace ({trace_mb:.1f} MB, {dev_us / 1e3:.3f} ms of "
        f"device time); Timings in chiprun_out/phase18_*")
    tmp.cleanup()

    launched = {w.__name__: w.launches for w in wrappers}
    if any(launched.values()):
        raise AssertionError(f"streaming: a kernel launched on a path that has none: {launched}")
    secs = time.perf_counter() - t_phase
    res["line"] = (f"streaming (phase 18, {secs:.1f} s): s per leaf {leaf_s[-1]:.3f} "
                   f"({SB_CUT_LEAF} selections), final {res['final_s']:.3f} s "
                   f"({SB_CUT_FINAL}); out-of-core peak {peak_txt}; checkpoint "
                   f"{1e3 * float(np.mean(ck_s)):.2f} ms a leaf; CSV native "
                   f"{res['native_mbs']:.1f} vs numpy {res['numpy_mbs']:.1f} MB/s (host); "
                   f"K1/K2/K3 launches {list(launched.values())}")
    return res

def _same_group_build(what: str, got, ref, tol: float) -> str:
    """Raises unless two group builds select the same groups, indices and
    m, with weights within tol * max|w|; returns a summary."""
    if not torch.equal(got.selected.cpu(), ref.selected.cpu()):
        raise AssertionError(f"{what}: selected groups differ: "
                             f"{torch.nonzero(got.selected)[:, 0].tolist()} against "
                             f"{torch.nonzero(ref.selected)[:, 0].tolist()}")
    g, r = got.core, ref.core
    if int(g.m) != int(r.m) or not torch.equal(g.idcs.cpu(), r.idcs.cpu()):
        raise AssertionError(f"{what}: selections differ: m={int(g.m)} against m={int(r.m)}")
    scale = float(r.wts.abs().max())
    err = float((g.wts.cpu() - r.wts.cpu()).abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{what}: weights differ by {err:.3e} > {tol * scale:.3e}")
    return f"same groups, m={int(g.m)} and indices, max |dw| {err:.3e} <= {tol * scale:.3e}"


def _same_tensors(what: str, got, want, tol: float = 0.0) -> str:
    """Raises unless each pair of tensors agrees within tol * max(1, max|want|)
    (tol 0: bit for bit); returns a summary."""
    errs = []
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}[{k}]: shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
        bound = tol * max(1.0, float(w.double().abs().max()) if w.numel() else 0.0)
        if not err <= bound:
            raise AssertionError(f"{what}[{k}]: differs by {err:.3e} > {bound:.3e}")
        errs.append(err)
    return f"max |diff| {max(errs):.3e} ({'bit for bit' if max(errs) == 0 else f'tol {tol:g}'})"


def phase_parallel(seed: int, card: str, mcmc: dict, dev: str = "cuda",
                   gc_n: int = GC_N, v_n: int = FAM_ROWS) -> dict:
    """Phase 19: the rest of parallel/ (the sharded group build, BPSVI lanes,
    HMC/NUTS chains, the flow trainer, Shapley over a mesh and the sharded
    NIW build), each on a (1, 1) NCCL mesh (a world of one rank met through
    a FileStore) at its example's widths and held against its single-device
    counterpart on the card under the same draws (the module docstring's
    a-g). Returns K2's launches in (b)'s measured selection and one line."""
    import betacores_tpu_torch as bc
    from betacores_tpu_torch.coresets import (BPSVIConfig, FixedDraws, bpsvi_build_batch,
                                              group_ids_from_groups, init_group_state,
                                              make_bpsvi_builder,
                                              make_group_incremental_builder)
    from betacores_tpu_torch.inference import (HMCConfig, SHFConfig, default_nuts_config,
                                               init_shf_params, make_sharded_shf_trainer,
                                               make_shf_trainer, run_chains, run_chains_nuts,
                                               run_chains_sharded)
    from betacores_tpu_torch.models import multiclass, mvn
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.ops.projection import Groups
    from betacores_tpu_torch.parallel import (make_mesh, make_sharded_bpsvi_batch,
                                              make_sharded_group_builder, shard_data,
                                              shard_group_ids, world_of_one)
    from betacores_tpu_torch.valuation import (logreg_laplace_value_fn, make_dshapley,
                                               make_tmc_shapley)

    t_phase = time.perf_counter()
    k2 = kernels.multiclass_projection
    keyed = lambda s: torch.Generator(device=dev).manual_seed(s)
    gen = keyed(seed + 19)
    summary = []
    with world_of_one("nccl" if dev == "cuda" else "gloo"):
        mesh = make_mesh(1, 1, device=dev)

        def sharded_groups(Z, gp, model, sampler, cfg):
            Zs, n_true = shard_data(Z, mesh)
            gid = shard_group_ids(group_ids_from_groups(gp, Z.shape[0]), mesh, gp.n_groups)
            return make_sharded_group_builder(Zs, gid, n_true, gp, model, sampler, cfg, mesh)

        # --- a. examples/bench_group_pass.py --end-to-end through the sharded builder ---
        X, y, _ = bc.gen_synthetic_logreg(gen, GB_N, d=N_FEAT)
        X, y, Zb, _ = bc.perturb_logreg(gen, X, y, f_rate=0.1)
        del X, y
        per = GB_N // GB_G
        gp = Groups.from_lists([range(g * per, (g + 1) * per) for g in range(GB_G)], dev)
        cfg = bc.IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                   n_subsample_opt=None, opt_itrs=GB_ITRS, i0=1.0, use_beta=True)
        sb = sharded_groups(Zb, gp, bc.logreg.bundle(), bc.logreg_laplace_sampler(), cfg)
        if sb.onehot is not None:
            raise AssertionError("N G 4 bytes above the gate: the sharded build should scatter")
        gst0 = init_group_state(bc.init_state((GB_M + 1) * per, N_FEAT, beta=GB_BETA,
                                              device=dev), GB_G)
        _, t_warm = _synced(lambda: sb.build(gst0, 1, sb.generator_draws(seed)))
        mesh.calls.clear()
        got, secs = _synced(lambda: sb.build(gst0, PAR_GB_SELECTIONS,
                                             sb.generator_draws(seed + 191)))
        calls = dict(mesh.calls)
        single = make_group_incremental_builder(Zb, gp, bc.logreg.bundle(),
                                                bc.logreg_laplace_sampler(), cfg)
        ref, secs_1 = _synced(lambda: single.build(gst0, PAR_GB_SELECTIONS,
                                                   single.generator_draws(keyed(seed + 191))))
        check_state(got.core)
        same = _same_group_build("parallel a", got, ref, GRAPH_TOL)
        steps = PAR_GB_SELECTIONS * GB_ITRS
        log(f"parallel a, sharded logistic group build on a {mesh.shape} mesh: N={GB_N}, "
            f"G={GB_G} groups of {per}, buffer {(GB_M + 1) * per} slots, S={S}, {GB_ITRS} "
            f"exact-gradient steps (eager); warm-up {t_warm:.2f} s; {PAR_GB_SELECTIONS} "
            f"selections {secs:.3f} s ({secs / PAR_GB_SELECTIONS:.4f} s per selection, "
            f"{secs / steps * 1e3:.3f} ms per Adam step), collectives {calls}; the "
            f"single-device build (captured) {secs_1:.3f} s; {card}")
        log(f"parallel a, sharded == single-device: {same}")
        summary.append(f"group {secs / PAR_GB_SELECTIONS:.3f} s/selection")
        del sb, single, got, ref, Zb, gp
        torch.cuda.empty_cache()

        # --- b. the multiclass sharded group build: K2 on the samp = 1 route ---
        K, d = MC_K, MC_D
        _, _, Zm = bc.gen_synthetic_multiclass(gen, gc_n, d=d, n_classes=K)
        Zm, _ = bc.flip_labels(gen, Zm, K, MC_F_RATE)
        per = gc_n // GC_G
        gp = Groups.from_lists([range(g * per, (g + 1) * per) for g in range(GC_G)], dev)
        cfg = bc.IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                   n_subsample_opt=None, opt_itrs=GC_ITRS, i0=1.0, use_beta=True)
        sb = sharded_groups(Zm, gp, multiclass.bundle(K), bc.multiclass_laplace_sampler(K), cfg)
        gst0 = init_group_state(bc.init_state(GC_BUF_GROUPS * per, d + 1, beta=MC_BETA,
                                              device=dev,
                                              sampler_aux=torch.zeros(K * d, device=dev)), GC_G)
        _, t_warm = _synced(lambda: sb.build(gst0, 1, sb.generator_draws(seed)))
        k2.launches = 0
        got, secs = _synced(lambda: sb.build(gst0, PAR_GC_SELECTIONS,
                                             sb.generator_draws(seed + 192)))
        launches = k2.launches
        per_sel = (2 + 2 * GC_ITRS if kernels.maybe_fused(GC_BUF_GROUPS * per)
                   else 1 + GC_ITRS)
        if dev == "cuda" and launches != PAR_GC_SELECTIONS * per_sel:
            raise AssertionError(f"parallel b: K2 launched {launches} times, want "
                                 f"{PAR_GC_SELECTIONS * per_sel}")
        check_state(got.core)
        steps = PAR_GC_SELECTIONS * GC_ITRS
        log(f"parallel b, sharded multiclass group build: N={gc_n}, K={K}, d={d}, G={GC_G} "
            f"groups of {per}, buffer {GC_BUF_GROUPS * per} slots, {GC_ITRS} exact-gradient "
            f"steps (eager); warm-up {t_warm:.2f} s; {PAR_GC_SELECTIONS} selection(s) "
            f"{secs:.3f} s ({secs / steps * 1e3:.3f} ms per Adam step); {launches} K2 launches "
            f"({per_sel} a selection: the local rows and the buffer at select and every step); "
            f"selected {torch.nonzero(got.selected)[:, 0].tolist()}; {card}")
        summary.append(f"multiclass group {secs / PAR_GC_SELECTIONS:.3f} s/selection, "
                       f"{launches} K2")
        del sb, got, Zm, gp
        torch.cuda.empty_cache()
        # at N = 9000 on the card (K2 every select and step) against the CPU
        N9, K9, d9, S9, itrs, T9 = 9000, 3, 4, 32, 3, 20
        g9 = torch.Generator().manual_seed(seed)
        _, _, Z9 = bc.gen_synthetic_multiclass(g9, N9, d=d9, n_classes=K9)
        Z9, _ = bc.flip_labels(g9, Z9, K9, MC_F_RATE)
        lists = [range(g * 100, (g + 1) * 100) for g in range(N9 // 100 - 1)]
        for dedup in (False, True):
            cfg9 = bc.IncrementalConfig(projection_dim=S9, n_subsample_select=None,
                                        n_subsample_opt=None, opt_itrs=T9, i0=0.5, use_beta=True,
                                        dedup_select=dedup)
            at = lambda where: init_group_state(bc.init_state(
                400, d9 + 1, beta=MC_BETA, device=where,
                sampler_aux=torch.zeros(K9 * d9, device=where)), len(lists))
            cpu = make_group_incremental_builder(Z9, Groups.from_lists(lists, "cpu"),
                                                 multiclass.bundle(K9),
                                                 bc.multiclass_laplace_sampler(K9), cfg9)
            rec = cpu.generator_draws(g9)
            draws = FixedDraws([rec.select(i, at("cpu").core) for i in range(itrs)],
                               [rec.optimize(i, at("cpu").core) for i in range(itrs)])
            want = cpu.build(at("cpu"), itrs, draws)
            card_b = sharded_groups(Z9.to(dev), Groups.from_lists(lists, dev),
                                    multiclass.bundle(K9), bc.multiclass_laplace_sampler(K9),
                                    cfg9)
            before = k2.launches
            out = card_b.build(at(dev), itrs, draws)
            n_k = k2.launches - before
            tag = f"parallel b self-check [dedup_select={dedup}]"
            if dev == "cuda" and n_k != itrs * (1 + T9):
                raise AssertionError(f"{tag}: K2 launched {n_k} times, want {itrs * (1 + T9)}")
            log(f"{tag}: sharded build on the card == single-device build on the CPU "
                f"({_same_group_build(tag, out, want, 5e-3)}); {n_k} K2 launches")

        # --- c. BPSVI lanes at examples/zellner_logreg.py's widths over 1M rows ---
        X, y, _ = bc.gen_synthetic_logreg(gen, N_ROWS, d=N_FEAT)
        X, y, Zp, _ = bc.perturb_logreg(gen, X, y, f_rate=0.1)
        del X, y
        bcfg = BPSVIConfig(projection_dim=S, n_subsample_opt=N_OPT, opt_itrs=BP_ITRS, i0=1.0)
        aux0 = torch.zeros(N_FEAT, device=dev)
        batch = make_sharded_bpsvi_batch(Zp, bc.logreg.bundle(), bc.logreg_laplace_sampler(),
                                         bcfg, mesh)
        mesh.calls.clear()
        lanes, secs = _synced(lambda: batch(keyed(seed + 193), BP_SIZES, BP_M, aux0))
        calls = dict(mesh.calls)
        builder = make_bpsvi_builder(Zp, bc.logreg.bundle(), bc.logreg_laplace_sampler(), bcfg)
        ref, secs_1 = _synced(lambda: bpsvi_build_batch(builder, keyed(seed + 193), BP_SIZES,
                                                        BP_M, aux0))
        same = _same_tensors("parallel c", lanes, ref)
        if not bool(torch.isfinite(lanes[0]).all()):
            raise AssertionError("parallel c: non-finite lane weights")
        log(f"parallel c, make_sharded_bpsvi_batch over sizes {BP_SIZES} (N={N_ROWS}, "
            f"{BP_ITRS} steps on {N_OPT} rows): {secs:.3f} s ({secs / len(BP_SIZES):.3f} s a "
            f"lane), collectives {calls}; bpsvi_build_batch {secs_1:.3f} s; every lane == "
            f"bpsvi_build_batch's: {same}; {card}")
        summary.append(f"BPSVI lanes {secs / len(BP_SIZES):.3f} s/lane")
        del batch, builder, Zp, lanes, ref
        torch.cuda.empty_cache()

        # --- d. HMC and NUTS chains on phase 17's m = 100 coreset ---
        pm, wm = mcmc["coreset"]
        lp = lambda th: bc.logreg.log_joint(pm, th, wm)
        theta0 = torch.zeros(pm.shape[1], device=dev)
        for name, cfg_c, single_run in (
                ("HMC", HMCConfig(n_samples=ZL_SAMPLES, n_warmup=ZL_WARMUP, L_max=ZL_L_MAX),
                 run_chains),
                ("NUTS", default_nuts_config(ZL_SAMPLES, ZL_WARMUP), run_chains_nuts)):
            mesh.calls.clear()
            (s_sh, st_sh), secs = _synced(lambda: run_chains_sharded(
                keyed(seed + 194), lp, theta0, ZL_CHAINS, mesh, cfg_c))
            calls = dict(mesh.calls)
            (s_1, st_1), secs_1 = _synced(lambda: single_run(keyed(seed + 194), lp, theta0,
                                                             ZL_CHAINS, cfg_c))
            names = sorted(st_1)
            same = _same_tensors(f"parallel d {name}", [s_sh] + [st_sh[k] for k in names],
                                 [s_1] + [st_1[k] for k in names], 1e-6)
            if not bool(torch.isfinite(s_sh).all()):
                raise AssertionError(f"parallel d {name}: non-finite draws")
            log(f"parallel d, run_chains_sharded {name} ({ZL_CHAINS} chains, {ZL_WARMUP} + "
                f"{ZL_SAMPLES}) on the m={ZL_M} coreset: {secs:.3f} s, collectives {calls}; "
                f"the single-device runner {secs_1:.3f} s; every chain == its chain: {same}; "
                f"{card}")
            summary.append(f"{name} chains {secs:.1f} s")

        # --- e. the sharded flow trainer at examples/shf_logreg.py's widths ---
        g_s = keyed(seed + 171)
        _, _, Zs = bc.gen_synthetic_logreg(g_s, SHF_N, d=SHF_D)
        scfg = SHFConfig(n_blocks=SHF_BLOCKS, n_leapfrog=SHF_LEAP, n_mc=SHF_MC, n_batch=SHF_B,
                         learning_rate=SHF_LR)
        params = init_shf_params(Zs[:SHF_M], SHF_D, SHF_N, scfg)
        train = make_sharded_shf_trainer(Zs, bc.logreg.log_joint, mesh, scfg)
        mesh.calls.clear()
        (p_sh, tr_sh), secs = _synced(lambda: train(keyed(seed + 195), params, PAR_SHF_STEPS))
        calls = dict(mesh.calls)
        (p_1, tr_1), secs_1 = _synced(lambda: make_shf_trainer(Zs, bc.logreg.log_joint, scfg)(
            keyed(seed + 195), params, PAR_SHF_STEPS))
        same = _same_tensors("parallel e", list(p_sh) + [tr_sh], list(p_1) + [tr_1])
        if not bool(torch.isfinite(tr_sh).all()):
            raise AssertionError("parallel e: non-finite ELBO")
        log(f"parallel e, make_sharded_shf_trainer ({SHF_MC} lanes, B={SHF_B}, "
            f"{PAR_SHF_STEPS} of {SHF_STEPS} steps, captured with its two all-reduces; the "
            f"trainer's first call, its eager first step and capture included): {secs:.3f} s "
            f"({secs / PAR_SHF_STEPS * 1e6:.1f} us a step), collectives {calls}; "
            f"make_shf_trainer {secs_1:.3f} s; params and ELBO == make_shf_trainer's: {same}; "
            f"{card}")
        summary.append(f"SHF {secs / PAR_SHF_STEPS * 1e6:.0f} us/step")
        del Zs, train

        # --- f. Shapley over the mesh on phase 15 (a)'s movielens groups ---
        Z, Xt, Yt, glists = movielens_groups()
        vargs = tuple(torch.from_numpy(a).to(dev) for a in (Z, Xt, Yt))
        G = len(glists)
        gp = Groups.from_lists(glists, dev)
        gid = group_ids_from_groups(gp, Z.shape[0])
        value_fn = logreg_laplace_value_fn(n_samples=256)
        full_value = float(value_fn(value_fn.draw(gen, *vargs), (gid < G).float(), *vargs))
        g_v = keyed(seed + 196)
        for name, make, T in (
                ("DShapley", lambda mesh: make_dshapley(
                    gid, gp, value_fn, max_groups=min(SHAP_GROUPS, G), group_cap=SHAP_CAP,
                    mesh=mesh, value_args=vargs), SHAP_T),
                ("TMC", lambda mesh: make_tmc_shapley(
                    gid, gp, value_fn, full_value=full_value, group_cap=SHAP_CAP, mesh=mesh,
                    value_args=vargs), TMC_T)):
            est_1, est_sh = make(None), make(mesh)
            rounds = [est_1.draws(g_v) for _ in range(T)]
            mesh.calls.clear()
            phis_sh, secs = _synced(lambda: est_sh(rounds, T))
            calls = dict(mesh.calls)
            phis_1, secs_1 = _synced(lambda: est_1(rounds, T))
            same = _same_tensors(f"parallel f {name}", [phis_sh], [phis_1], 1e-6)
            log(f"parallel f, {name} with mesh= (T={T}): {secs:.3f} s, collectives {calls}; "
                f"mesh=None {secs_1:.3f} s; phis == mesh=None's: {same}; top "
                f"{torch.argsort(phis_sh, descending=True)[:GRP_M].tolist()}; {card}")
        summary.append("Shapley over the mesh")

        # --- g. the sharded NIW build at examples/mvn_unknown_cov.py's widths ---
        d = V_D
        eye = lambda k: torch.eye(k, device=dev)
        A = 0.3 * torch.randn((d, d), generator=gen, device=dev)
        L_true = torch.linalg.cholesky(A @ A.T + eye(d))
        X = 2.0 + torch.randn((v_n, d), generator=gen, device=dev) @ L_true.T
        Xout = V_SHIFT + 0.5 * torch.randn((int(V_F_RATE * v_n), d), generator=gen, device=dev)
        Xc = torch.cat([X, Xout])
        del X, Xout
        prior = (torch.zeros(d, device=dev), 1.0, 2.0 * eye(d), d + 4.0)
        vcfg = bc.IncrementalConfig(projection_dim=V_S, n_subsample_select=V_N_SEL,
                                    n_subsample_opt=V_N_OPT, opt_itrs=V_ITRS, i0=V_I0,
                                    use_beta=True)
        Xs, n_true = shard_data(Xc, mesh)
        sb = bc.make_sharded_incremental_builder(Xs, n_true, mvn.bundle(d),
                                                 mvn.mvn_niw_sampler(*prior), vcfg, mesh)
        if sb.route != "per_step":
            raise AssertionError(f"the sharded NIW build took the {sb.route} route")
        st0 = bc.init_state(V_M, d, beta=V_BETA, device=dev,
                            sampler_aux=torch.zeros(d + d * d, device=dev))
        # one generator for the sampler's and the subsample's draws: the
        # single-device per-step-draw stream
        draws = sb.generator_draws(seed + 197)
        draws.local = draws.replicated
        mesh.calls.clear()
        got, secs = _synced(lambda: sb.build(st0, PAR_V_SELECTIONS, draws))
        calls = dict(mesh.calls)
        single = bc.make_incremental_builder(Xc, mvn.bundle(d), mvn.mvn_niw_sampler(*prior),
                                             vcfg)
        ref, secs_1 = _synced(lambda: single.build(
            st0, PAR_V_SELECTIONS, single.generator_draws(keyed(seed + 197))))
        check_state(got)
        same = check_same_build("parallel g", got, ref)
        steps = PAR_V_SELECTIONS * V_ITRS
        log(f"parallel g, sharded NIW build (per-step draws, eager) over {len(Xc)} rows, "
            f"d={d}, S={V_S}: {PAR_V_SELECTIONS} selections {secs:.3f} s "
            f"({secs / steps * 1e3:.3f} ms per Adam step), collectives {calls}; the "
            f"single-device build (captured) {secs_1:.3f} s; sharded == single-device: "
            f"{same}; {card}")
        summary.append(f"NIW {secs / steps * 1e3:.2f} ms/step")
        del Xc, Xs, sb, single
        torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"parallel: phase 19 in {secs:.1f} s; {launches} K2 launches in (b)'s selection")
    return {"K2": launches, "line": f"parallel (phase 19, {secs:.1f} s): " + ", ".join(summary)}

# the child that loads an exported build: it imports utils.export and nothing of a
# builder or a model family, runs the artifact at each requested size and saves what
# came out with its seconds and the kernels' launches
EXPORT_CHILD = """
import sys, time, torch
from betacores_tpu_torch.utils.export import BuildDraws, load_program_file
from betacores_tpu_torch.ops import kernels
art, ops, out, runs, dev = sys.argv[1:6]
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
call = load_program_file(art, device=dev)
loaded = sorted(m for m in sys.modules if m.startswith("betacores_tpu_torch."))
builders = [m for m in loaded if m.startswith(("betacores_tpu_torch.coresets.incremental",
                                               "betacores_tpu_torch.coresets.api"))
            or (m.startswith("betacores_tpu_torch.models.") and not m.endswith(".base"))]
if builders:
    raise SystemExit(f"loading the artifact imported {builders}")
from betacores_tpu_torch.coresets.state import CoresetState
o = torch.load(ops)
res = {"modules": len(loaded), "runs": {}}
for itrs in (int(r) for r in runs.split(",")):
    k1, k2 = kernels.logreg_adam_step.launches, kernels.multiclass_projection.launches
    sync()
    t0 = time.perf_counter()
    st = call(o["data"], BuildDraws(*o["draws"]), CoresetState(*o["state"]),
              torch.tensor(itrs, device=dev))
    sync()
    res["runs"][itrs] = {"s": time.perf_counter() - t0,
                         "state": tuple(t.cpu() for t in st),
                         "K1": kernels.logreg_adam_step.launches - k1,
                         "K2": kernels.multiclass_projection.launches - k2}
torch.save(res, out)
"""


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class _ExportRun:
    """One exported build: ``export`` exports ``builder``'s build and saves
    it with its operands, ``launch`` starts a fresh process that loads it
    and runs it at each size of ``runs`` (``EXPORT_CHILD``), ``finish``
    waits for that process and holds each run against the live builder on
    the same stacked draws, and returns the artifact's launches and the
    seconds a selection of both."""

    def __init__(self, tag: str, builder, data, st0, draws, runs, tmp: str, dev: str):
        import os

        self.tag, self.builder, self.data, self.st0, self.draws = tag, builder, data, st0, draws
        self.runs, self.dev = runs, dev
        self.art, self.ops, self.out = (os.path.join(tmp, f"{tag}.{ext}")
                                        for ext in ("pt2", "ops.pt", "out.pt"))

    def export(self) -> "_ExportRun":
        from betacores_tpu_torch.utils.export import export_incremental_build

        t0 = time.perf_counter()
        blob = export_incremental_build(self.builder, self.data, self.st0,
                                        draws_spec=self.draws)
        self.t_export, self.mib = time.perf_counter() - t0, len(blob) / 2**20
        with open(self.art, "wb") as fh:
            fh.write(blob)
        torch.save({"data": self.data, "draws": tuple(self.draws), "state": tuple(self.st0)},
                   self.ops)
        return self

    def launch(self) -> "_ExportRun":
        import os

        env = dict(os.environ)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (here, env.get("PYTHONPATH")) if p)
        self.t_launch = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", EXPORT_CHILD, self.art, self.ops, self.out,
             ",".join(map(str, self.runs)), self.dev], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        return self

    def finish(self) -> dict:
        from betacores_tpu_torch.coresets.state import CoresetState
        from betacores_tpu_torch.ops import kernels
        from betacores_tpu_torch.utils.export import fixed_draws

        tag, dev = self.tag, self.dev
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        try:
            _, err = self.proc.communicate(timeout=900)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        t_child = time.perf_counter() - self.t_launch
        if self.proc.returncode != 0:
            raise RuntimeError(f"export {tag}: the loading process failed:\n{err[-4000:]}")
        res = torch.load(self.out)
        lines, k1, k2, live_k2 = [], 0, 0, 0
        for itrs in self.runs:
            r = res["runs"][itrs]
            got = CoresetState(*(t.to(dev) for t in r["state"]))
            k2_0 = kernels.multiclass_projection.launches
            sync()
            t0 = time.perf_counter()
            live = self.builder.build(self.st0, itrs, fixed_draws(self.draws))
            sync()
            r["live_s"] = time.perf_counter() - t0
            live_k2 += kernels.multiclass_projection.launches - k2_0
            check_state(got)
            summary = check_same_build(f"export {tag}, itrs={itrs}", got, live)
            same = all(torch.equal(a, b) for a, b in zip(got, live))
            first = ", its first build capturing" if itrs == self.runs[0] else ""
            lines.append(f"itrs={itrs}: {summary}, bit-identical {same}; "
                         f"{r['s'] / itrs:.3f} s a selection (artifact) against "
                         f"{r['live_s'] / itrs:.3f} s (live, captured{first}); "
                         f"launches in the artifact K1 {r['K1']}, K2 {r['K2']}")
            k1, k2 = k1 + r["K1"], k2 + r["K2"]
        log(f"export {tag}: exported in {self.t_export:.2f} s ({self.mib:.1f} MiB artifact, "
            f"draws operand {_nbytes(self.draws) / 2**20:.1f} MiB), loaded and run in a fresh "
            f"process importing {res['modules']} modules of the port and no builder or model "
            f"family ({t_child:.1f} s with its start)")
        for line in lines:
            log(f"export {tag}, {line}")
        last = res["runs"][self.runs[-1]]
        return {"K1": k1, "K2": k2, "live_K2": live_k2,
                "art_s": last["s"] / self.runs[-1], "live_s": last["live_s"] / self.runs[-1]}


def _finite(what: str, value) -> None:
    """Raises unless every number in ``value`` (dicts, lists, arrays) is
    finite; None, strings and a driver's ``args`` are skipped."""
    if isinstance(value, dict):
        for k, v in value.items():
            if k != "args":
                _finite(f"{what}.{k}", v)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _finite(f"{what}[{i}]", v)
    elif isinstance(value, (float, int, np.ndarray, np.generic)) and not isinstance(value, bool):
        a = np.asarray(value)
        if a.dtype.kind in "fiu" and not np.isfinite(a).all():
            raise AssertionError(f"{what} is not finite: {value}")


def phase_export(seed: int, card: str, dev: str = "cuda", n: int = N_ROWS,
                 mc_n: int = MC_ROWS, stack: int = EXP_STACK) -> dict:
    """Phase 20: the build exported as a loadable program, and the ported
    drivers.

    (a) the headline logistic build (bench.py's widths: n contaminated rows,
        d = 10, a 128-slot buffer, S = 100, a 1000-row select, 500 Adam steps
        on 200 rows, beta = 0.1) exported on the card
        (``export_incremental_build``) with its draws stacked for ``stack``
        selections, saved, loaded by a fresh process that imports
        ``utils.export`` and no builder, and run at 2 and 3 selections from
        that one artifact (every Adam step K1's op); each run held against
        the live, graph-captured build on the same draws: the same ``idcs``
        and m, weights within 5e-3 max(1, max|w|), and whether bit-identical;
    (b) the multiclass build of phase 6 (N = mc_n, K = 5, d = 10, full
        select, S = 100) exported the same way and run at 2 selections
        (K2's op at every select);
    (c) each ported driver once through its ``main()`` on the card, at its
        defaults cut in depth (EX_CUTS); each pickle must carry the JAX
        driver's keys (EX_KEYS) with finite numbers; ``run_sweep`` runs one
        grid point with ``--index`` and ``plot_results`` plots the Gaussian
        pickles (skipped, and said, without matplotlib).
    Returns the launches of K1 and K2 in the phase and one summary line."""
    import importlib
    import importlib.util
    import os
    import pickle
    import tempfile

    from betacores_tpu_torch import (IncrementalConfig, flip_labels, gen_synthetic_logreg,
                                     gen_synthetic_multiclass, init_state, logreg,
                                     logreg_laplace_sampler, make_incremental_builder,
                                     multiclass, multiclass_laplace_sampler, perturb_logreg)
    from betacores_tpu_torch.ops import kernels
    from betacores_tpu_torch.utils.export import stack_draws

    t_phase = time.perf_counter()
    summary = []
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        # --- (a) the headline logistic build ---
        gen = torch.Generator(device=dev).manual_seed(seed + 20)
        X, y, _ = gen_synthetic_logreg(gen, n, d=N_FEAT)
        X, y, Z, _ = perturb_logreg(gen, X, y, f_rate=0.1)
        cfg = IncrementalConfig(projection_dim=S, n_subsample_select=N_SEL,
                                n_subsample_opt=N_OPT, opt_itrs=OPT_ITRS, i0=1.0,
                                use_beta=True)
        builder = make_incremental_builder(Z, logreg.bundle(), logreg_laplace_sampler(), cfg)
        st0 = init_state(M_BUF, N_FEAT, beta=BETA, device=dev)
        draws = stack_draws(builder, gen, st0, stack)
        k1_0 = kernels.logreg_adam_step.launches
        a = _ExportRun("headline", builder, Z, st0, draws, EXP_ITRS, tmp, dev).export().launch()
        a = a.finish()
        k1_live = kernels.logreg_adam_step.launches - k1_0
        want = sum(EXP_ITRS) * OPT_ITRS if dev == "cuda" else 0
        if a["K1"] != want or k1_live != want:
            raise AssertionError(f"export headline: K1 launched {a['K1']} times in the "
                                 f"artifact and {k1_live} in the live builds, want {want} each")
        summary.append(f"headline {a['art_s']:.2f} s/sel exported, {a['live_s']:.3f} live")
        del X, y, Z, builder, draws

        # --- (b) the multiclass build, full select ---
        K, d = MC_K, MC_D
        gen = torch.Generator(device=dev).manual_seed(seed + 21)
        _, _, Zm = gen_synthetic_multiclass(gen, mc_n, d=d, n_classes=K)
        Zm, _ = flip_labels(gen, Zm, K, MC_F_RATE)
        cfg = IncrementalConfig(projection_dim=S, n_subsample_select=None,
                                n_subsample_opt=MC_N_OPT, opt_itrs=MC_OPT_ITRS, i0=1.0,
                                use_beta=True)
        builder = make_incremental_builder(Zm, multiclass.bundle(K),
                                           multiclass_laplace_sampler(K), cfg)
        st0 = init_state(MC_M, d + 1, beta=MC_BETA, device=dev,
                         sampler_aux=torch.zeros(K * d, device=dev))
        draws = stack_draws(builder, gen, st0, MCX_ITRS)
        b = _ExportRun("multiclass", builder, Zm, st0, draws, (MCX_ITRS,), tmp, dev)
        b = b.export().launch().finish()
        want = MCX_ITRS if dev == "cuda" else 0
        if b["K2"] != want or b["live_K2"] != want:
            raise AssertionError(f"export multiclass: K2 launched {b['K2']} times in the "
                                 f"artifact and {b['live_K2']} in the live build, want "
                                 f"{want} each (one a select)")
        summary.append(f"multiclass {b['art_s']:.2f} s/sel exported, {b['live_s']:.3f} live")
        del Zm, builder, draws
        if dev == "cuda":
            torch.cuda.empty_cache()

        # --- (c) the drivers ---
        k1_0, k2_0 = kernels.logreg_adam_step.launches, kernels.multiclass_projection.launches
        secs = {}
        for name, cut in EX_CUTS.items():
            out_dir = os.path.join(tmp, "results", name)
            log(f"driver {name}: python -m betacores_tpu_torch.examples.{name} "
                f"{' '.join(cut)} (its defaults otherwise; the cut: {' '.join(cut)})")
            mod = importlib.import_module(f"betacores_tpu_torch.examples.{name}")
            sync()
            t0 = time.perf_counter()
            got = mod.main(cut + ([] if name == "shf_logreg" else ["--results-dir", out_dir])
                           + ["--device", dev])
            sync()
            secs[name] = time.perf_counter() - t0
            if name == "shf_logreg":
                _finite(name, got)
                log(f"driver {name}: {secs[name]:.1f} s, {got}")
                continue
            with open(got, "rb") as fh:
                res = pickle.load(fh)
            missing = EX_KEYS[name] - set(res)
            if missing or set(res) - EX_KEYS[name]:
                raise AssertionError(f"driver {name}: pickle keys {sorted(res)}, the JAX "
                                     f"driver's {sorted(EX_KEYS[name])}")
            _finite(name, res)
            log(f"driver {name}: {secs[name]:.1f} s, {os.path.basename(got)} with the JAX "
                f"driver's keys, every number finite")
        from betacores_tpu_torch.examples import plot_results, run_sweep

        sweep_dir = os.path.join(tmp, "results", "sweep")
        t0 = time.perf_counter()
        run_sweep.main(["--exp", "gaussian", "--index", "0", "--results-dir", sweep_dir,
                        "--", "--M", "3", "--device", dev])
        secs["run_sweep"] = time.perf_counter() - t0
        files = sorted(os.listdir(sweep_dir)) if os.path.isdir(sweep_dir) else []
        if files != ["results_BCORES_1_b0.1.pk"]:
            raise AssertionError(f"run_sweep --index 0 wrote {files}")
        log(f"driver run_sweep: --exp gaussian --index 0 -- --M 3 in {secs['run_sweep']:.1f} "
            f"s (a fresh process), wrote {files[0]}")
        if importlib.util.find_spec("matplotlib") is None:
            log("driver plot_results: skipped, matplotlib is not installed on this machine")
        else:
            t0 = time.perf_counter()
            png = plot_results.main(["--kind", "gaussian", "--results-dir",
                                     os.path.join(tmp, "results", "zellner_gaussian"),
                                     "--out", os.path.join(tmp, "gaussian.png")])
            secs["plot_results"] = time.perf_counter() - t0
            if png is None or not os.path.getsize(png):
                raise AssertionError("plot_results wrote no figure")
            log(f"driver plot_results: --kind gaussian in {secs['plot_results']:.1f} s")
        k1_d = kernels.logreg_adam_step.launches - k1_0
        k2_d = kernels.multiclass_projection.launches - k2_0
    log(f"drivers: seconds {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}; K1 "
        f"{k1_d} and K2 {k2_d} launches in them; {card}")
    summary.append(f"drivers {sum(secs.values()):.0f} s")
    t = time.perf_counter() - t_phase
    log(f"export: phase 20 in {t:.1f} s")
    return {"K1": a["K1"] + k1_live + k1_d, "K2": b["K2"] + b["live_K2"] + k2_d,
            "line": f"export (phase 20, {t:.1f} s): " + ", ".join(summary)}


def write_raw_files(out: str, seed: int) -> dict:
    """Raw files of four preprocess subcommands, made from ``seed`` as
    tests/test_examples.py makes them (covtype: a numeric CSV with labels
    1-3; mnist2: an npz of byte pixels and digit labels; housing: a
    price-paid CSV and a GB_FULL.txt geocoding table; movielens: a ratings
    CSV): {subcommand: preprocess arguments}."""
    import os

    rng = np.random.default_rng(seed)
    cov = os.path.join(out, "cov.csv")
    np.savetxt(cov, np.c_[rng.normal(size=(PRE_ROWS, 5)), rng.integers(1, 4, size=PRE_ROWS)],
               delimiter=",")
    mnist = os.path.join(out, "mnist.npz")
    np.savez(mnist, X=rng.integers(0, 255, size=(PRE_ROWS, 16)),
             y=rng.integers(0, 10, size=PRE_ROWS))
    geo = os.path.join(out, "GB_FULL.txt")
    with open(geo, "w") as f:
        f.write("header\n" + "\n".join(
            "\t".join(["GB", code, "x", "x", "x", "x", "x", "x", "x", str(lat), str(lon), "1"])
            for code, lat, lon in [("AB1 0AA", 57.1, -2.2), ("ZZ9 9ZZ", 50.0, 0.1)]) + "\n")
    pp = os.path.join(out, "pp-2018.csv")
    with open(pp, "w") as f:
        f.write('"id","100000","2018","AB1 0AA","x"\n"id","250000","2018","ZZ9 9ZZ","x"\n'
                '"id","50000","2018","NO1 1NO","x"\n')
    ml = os.path.join(out, "ml.csv")
    with open(ml, "w") as f:
        f.write("\n".join(["userId,movieId,rating,timestamp"] + [
            f"{rng.integers(1, 12)},{rng.integers(1, 30)},"
            f"{rng.choice([1.0, 2.0, 3.0, 4.0, 5.0])},{rng.integers(9e8, 1e9)}"
            for _ in range(PRE_ROWS)]))
    return {"covtype": ["--raw", cov, "--pca", "3"], "mnist2": ["--raw", mnist],
            "housing": ["--raw", pp, geo], "movielens": ["--raw", ml, "--n-groups", "5",
                                                        "--cap", "20"]}


def phase_drivers(seed: int, card: str, dev: str = "cuda") -> dict:
    """Phase 21: the rest of the ported drivers and the entry points, each
    through its ``main(argv)`` (or ``entry``/``dryrun_multichip``) on the
    card, each printing its times beside the card's name and power limit.

    (a) dp_bpsvi at its defaults (N = 5000, d = 10, M = 30, 300 steps, the
        noise grid 0.5, 1, 2, 4): raises unless every finite-eps row's
        reverse KL is below a tenth of the prior's;
    (b) virtual_mesh_headline --mesh 1x1 (an NCCL world of one) --itrs
        MESH_ITRS at full width: raises unless ok, m = MESH_ITRS and K3
        launched MESH_ITRS x 500 times; then --full-data --itrs 2,
        --full-gradient --itrs 2 --opt-itrs 50, and --census --itrs 1, whose
        counts must equal the design's (``CENSUS``);
    (c) preprocess covtype, mnist2, housing and movielens on raw files
        written here (``write_raw_files``), then data_tabulate over the
        output, which must list every npz written;
    (d) bench_native_loader --rows BNL_ROWS --scale-rows 200000,
        bench_select_pass --reps 5,
        bench_group_pass --reps 5 --shapes 10000x100 1000000x100 and
        fulldata_roofline --configs fullopt --fullopt-itrs 5 --repeats 1,
        every number finite;
    (e) ``entry()`` once: raises unless K1 launched ENTRY_K1 times (one a
        step); then ``dryrun_multichip(1)``, NCCL in a world of one, every
        subsystem.
    Returns the launches of K1 and K3 in the phase and one summary line."""
    import importlib
    import os
    import tempfile

    from betacores_tpu_torch import entry as port_entry
    from betacores_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    ex = lambda name: importlib.import_module(f"betacores_tpu_torch.examples.{name}")
    k1, k3 = kernels.logreg_adam_step, kernels.logreg_shard_step_partials
    k1_0, k3_0 = k1.launches, k3.launches
    secs, summary = {}, []

    def run(tag: str, name: str, argv: list):
        log(f"driver {tag}: python -m betacores_tpu_torch.examples.{name} {' '.join(argv)}")
        t0 = time.perf_counter()
        out = ex(name).main(argv)
        secs[tag] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # --- (a) DP-BPSVI at its defaults ---
        rec = run("dp_bpsvi", "dp_bpsvi", ["--results-dir", os.path.join(tmp, "dp"),
                                           "--device", dev, "--seed", str(seed)])
        _finite("dp_bpsvi", [r["rkl"] for r in rec["rows"]] + [rec["rkl_prior"]])
        bad = [r for r in rec["rows"] if math.isfinite(r["eps"])
               and not r["rkl"] < rec["rkl_prior"] / 10]
        if bad or len(rec["rows"]) != 5:
            raise AssertionError(f"dp_bpsvi: rows {bad} not below a tenth of the prior's reverse "
                                 f"KL {rec['rkl_prior']:.4g} ({len(rec['rows'])} rows)")
        summary.append("dp eps " + "/".join(f"{r['eps']:g}" for r in rec["rows"][1:]))

        # --- (b) the headline on a (1, 1) NCCL mesh: K3 every Adam step ---
        mesh = ["--mesh", "1x1", "--device", dev, "--seed", str(seed)]
        k3_b = k3.launches
        rec = run("mesh headline", "virtual_mesh_headline", mesh + ["--itrs", str(MESH_ITRS)])
        launched = k3.launches - k3_b
        if not (rec["ok"] and rec["m"] == MESH_ITRS and launched == MESH_ITRS * OPT_ITRS
                and rec["route"] == "fused"):
            raise AssertionError(f"mesh headline: ok={rec['ok']}, m={rec['m']}, route "
                                 f"{rec['route']}, K3 {launched} launches (want "
                                 f"{MESH_ITRS * OPT_ITRS})")
        log(f"driver mesh headline: K3 launched {launched} times ({MESH_ITRS} x {OPT_ITRS}), "
            f"collectives {rec['calls']}")
        summary.append(f"mesh headline {rec['t_total'] / MESH_ITRS:.3f} s/selection, "
                       f"K3 {launched}")
        for tag, extra in (("mesh full-data", ["--full-data", "--itrs", "2"]),
                           ("mesh full-gradient", ["--full-gradient", "--itrs", "2",
                                                   "--opt-itrs", "50"]),
                           ("mesh census", ["--census", "--itrs", "1"])):
            rec = run(tag, "virtual_mesh_headline", mesh + extra)
            if not rec["ok"]:
                raise AssertionError(f"{tag}: not ok")
        if rec["census"] != ex("virtual_mesh_headline").CENSUS["headline"]:
            raise AssertionError(f"mesh census: {rec['census']}")

        # --- (c) preprocess on raw files written here, then the table ---
        raw = os.path.join(tmp, "raw")
        data_dir = os.path.join(tmp, "data")
        os.makedirs(raw)
        for cmd, argv in write_raw_files(raw, seed).items():
            run(f"preprocess {cmd}", "preprocess", [cmd] + argv + ["--out-dir", data_dir])
        written = sorted(f[:-4].upper() for f in os.listdir(data_dir) if f.endswith(".npz"))
        rows = run("data_tabulate", "data_tabulate", ["--dirs", data_dir])
        if sorted(r[0] for r in rows) != written or len(written) != 5:
            raise AssertionError(f"data_tabulate listed {[r[0] for r in rows]}, the npz files "
                                 f"are {written}")
        for r in rows:
            _finite(f"data_tabulate {r[0]}", r[1:])

        # --- (d) the microbenchmarks ---
        rec = run("bench_native_loader", "bench_native_loader",
                  ["--rows", str(BNL_ROWS), "--scale-rows", "200000",
                   "--workdir", os.path.join(tmp, "bnl"), "--device", dev])
        if rec is None:
            raise AssertionError("bench_native_loader: no C++ compiler for the native parser")
        _finite("bench_native_loader", rec)
        summary.append(f"native CSV {rec['csv']['native_mb_s']} MB/s, upload onto {dev} "
                       f"{rec['upload']['mb_s']} MB/s")
        rec = run("bench_select_pass", "bench_select_pass",
                  ["--reps", "5", "--device", dev, "--seed", str(seed)])
        _finite("bench_select_pass", rec)
        summary.append(f"select {rec['select']:.3f} ms/pass")
        rec = run("bench_group_pass", "bench_group_pass",
                  ["--reps", "5", "--shapes", "10000x100", "1000000x100", "--device", dev,
                   "--seed", str(seed)])
        _finite("bench_group_pass", rec)
        rec = run("fulldata_roofline", "fulldata_roofline",
                  ["--configs", "fullopt", "--fullopt-itrs", "5", "--repeats", "1",
                   "--device", dev, "--seed", str(seed)])
        _finite("fulldata_roofline", rec)
        if rec["fullopt"]["m"] < 1:
            raise AssertionError(f"fulldata_roofline: {rec}")
        summary.append(f"fullopt {rec['fullopt']['wall_s']} s")

    # --- (e) the entry points ---
    log("entry: betacores_tpu_torch.entry.entry() once, then dryrun_multichip(1)")
    t0 = time.perf_counter()
    fn, args = port_entry.entry(dev)
    k1_e = k1.launches
    out = fn(*args)
    check_state(out)
    k1_e = k1.launches - k1_e
    if k1_e != ENTRY_K1:
        raise AssertionError(f"entry: K1 launched {k1_e} times, want {ENTRY_K1}")
    secs["entry"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = port_entry.dryrun_multichip(1, dev)
    secs["dryrun_multichip(1)"] = time.perf_counter() - t0
    want = "cuda" if dev == "cuda" else "cpu"
    if dry["platform"] != want or len(dry["subsystems"]) != 9:
        raise AssertionError(f"dryrun_multichip: {dry}")
    log(f"entry: m={int(out.m)}, K1 {k1_e} launches; dryrun_multichip(1) on "
        f"{dry['platform']} over {dry['backend']}, {len(dry['subsystems'])} subsystems")

    launches = {"K1": k1.launches - k1_0, "K3": k3.launches - k3_0}
    t = time.perf_counter() - t_phase
    log(f"drivers (phase 21): seconds {', '.join(f'{k} {v:.1f}' for k, v in secs.items())}; "
        f"launches {launches}; {card}")
    return dict(launches, line=f"drivers (phase 21, {t:.1f} s): " + ", ".join(summary))


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
    neural = phase_neural_linear(args.seed, card)
    mcmc = phase_mcmc_eval(args.seed, card)
    streaming = phase_streaming(args.seed, card)
    parallel = phase_parallel(args.seed, card, mcmc)
    export = phase_export(args.seed, card)
    drivers = phase_drivers(args.seed, card)
    entries = [("logreg_adam_step", "logreg_adam_step.cu", "pallas_kernels.py:173",
                {"launches": main_path["launches"] + api["K1"] + mcmc["K1"] + export["K1"]
                 + drivers["K1"]}, k1),
               ("multiclass_projection", "multiclass_projection.cu", "pallas_kernels.py:330",
                {"launches": mc_path["launches"] + api["K2"] + hilbert["K2"] + groups["K2"]
                 + parallel["K2"] + export["K2"]}, k2),
               ("logreg_shard_step_partials", "logreg_shard_partials.cu", "pallas_kernels.py:249",
                {"launches": sharded["launches"] + drivers["K3"]}, k3)]
    log(families)
    log(hilbert["line"])
    log(groups["line"])
    log(neural)
    log(mcmc["line"])
    log(streaming["line"])
    log(parallel["line"])
    log(export["line"])
    log(drivers["line"])
    log(f"chip_smoke: phases 0-21 in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"betacores_tpu_torch/csrc/{src}",
         "replaces": f"betacores_tpu/ops/{tpu}", "launches": path["launches"], **k}
        for name, src, tpu, path, k in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
