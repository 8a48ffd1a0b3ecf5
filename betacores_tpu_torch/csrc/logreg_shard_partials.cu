// The shard-local, uncentred half of one sharded refinement step of the
// beta-Cores build, in one launch of one thread-block cluster.
//
// Replaces the TPU kernel
//   betacores_tpu/ops/pallas_kernels.py::_logreg_shard_partials_kernel
// (wrapper logreg_shard_step_partials). Same function, not the same
// blocking:
//   1. theta = z @ L^-1 + mu for this shard's S sample columns
//   2. margins m = -x . theta over the packed rows [local subsample;
//      coreset buffer], the (beta-)log-likelihood transform and the row
//      mask; NO centring (the mean is over the whole sample axis, which is
//      split across ranks)
//   3. colsum = column sums of the subsample rows, core = the buffer block,
//      corerow = the row sums of core, wcore = w . core
// The collectives and the Adam epilogue run outside, in
// betacores_tpu_torch/parallel/sharded.py.
//
// What bounds it on this card: not the roofline. At the sharded headline
// shapes (328 packed rows, d = 10, S = 100, s_pad = 128, M_pad = 128 on a
// (1, 1) mesh) a step moves ~86 KB, most of it the 128 x 128 core block
// written once (0.03 us at 3.35 TB/s), and does ~1 MFLOP; 500 such steps
// run back to back, each depending on the last through the weights. What
// is left is the launch floor (one cluster launch and two cluster
// barriers, a few us) and the step's own critical chain.
// The design is K1's (logreg_adam_step.cu), through the same row pass in
// logreg_common.cuh: ONE cluster of C CTAs, the packed rows split across
// them interleaved (never the sample axis, so each row sum stays in one
// warp), theta formed by every CTA and held in registers, the CTA's rows
// staged in shared memory (64 at a time) before the warps walk them. core
// and corerow are written straight from each row's registers, coalesced
// along the sample axis, and never read back; w . core and the subsample
// column sums are accumulated per warp, summed over the warps, then over
// the cluster through distributed shared memory in rank order, CTA r
// writing its share of the colsum and wcore columns. No atomics: the same inputs give the
// same bits on every launch.
//
// Layout (all float32, row-major, contiguous):
//   xin   (R, d+1)   rows [x | mask]: R = n_sub_pad + M_pad, subsample first
//   z     (s_pad, d) noise columns; rows from S on are ignored
//   mu    (d)        Laplace mode;  linv (d, d) = L^-1
//   w     (M_pad)    coreset weights
//   sc    (1)        [beta], read by the kernel, never on the host
// Outputs: colsum (s_pad), core (M_pad, s_pad), corerow (M_pad),
// wcore (s_pad); columns from S to s_pad and masked rows are written 0.

#include <cuda_runtime.h>

#include <algorithm>

#include "logreg_common.cuh"

namespace {

using namespace bcores;

size_t smem_floats(int R, int d, int S, int M_pad, int C) {
  // thT + per-warp subsample column sums + per-warp w . core partials
  // + a batch of the CTA's rows + the w of its slots
  const int n_core = ceil_div(M_pad, C);
  const int n_rows = std::min(kStageRows, ceil_div(R - M_pad, C) + n_core);
  return (size_t)d * S + 2 * (size_t)kWarps * S + (size_t)n_rows * (d + 1) + n_core;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
logreg_shard_partials_kernel(const float* __restrict__ xin,
                             const float* __restrict__ z,
                             const float* __restrict__ mu,
                             const float* __restrict__ linv,
                             const float* __restrict__ w,
                             const float* __restrict__ sc,
                             float* __restrict__ colsum,
                             float* __restrict__ core,
                             float* __restrict__ corerow,
                             float* __restrict__ wcore,
                             int R, int d, int S, int s_pad, int M_pad,
                             int use_beta) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = d + 1;
  const int n_sub_pad = R - M_pad;
  const RowSplit sp(rank, C, n_sub_pad, M_pad);

  extern __shared__ float smem[];
  float* thT = smem;                   // (d, S): theta transposed
  float* pc = thT + d * S;             // (kWarps, S): subsample column sums
  float* pw = pc + kWarps * S;         // (kWarps, S): w . core partials
  float* xs = pw + kWarps * S;         // (<= kStageRows, d+1): a batch of rows
  float* ws = xs + min(kStageRows, ceil_div(n_sub_pad, C) + ceil_div(M_pad, C)) * D1;
  // after the row pass: the CTA's partials, read by its peers, in place
  float* csum = pc;                    // (S): subsample column sums
  float* wsum = pw;                    // (S): w . core

  // 1. the first batch of rows and the slots' w copied in the background
  //    while theta is formed
  stage_rows_async(xin, D1, sp, 0, xs);
  stage_slots_async(w, sp, ws);
  const Likelihood ll(sc[0], use_beta);
  stage_theta<D>(z, mu, linv, d, S, thT);
  for (int e = tid; e < 2 * kWarps * S; e += kThreads) pc[e] = 0.f;  // pc and pw
  cp_async_wait_all();
  __syncthreads();
  Theta<D> th;
  th.load(thT, d, S, lane);

  // 2. one warp per row, lanes over samples
  float* pcw = pc + warp * S;
  float* pww = pw + warp * S;
  for_each_row(xin, D1, sp, xs, [&](int i, const float* xr) {
    const float msk = xr[d];
    const bool is_core = i >= sp.n_sub;  // warp-uniform
    const int m = is_core ? sp.slot(i - sp.n_sub) : 0;
    float* cr = core + (size_t)m * s_pad;
    if (msk != 0.f) {  // warp-uniform branch
      if (is_core) {
        const float wm = ws[i - sp.n_sub];
        float rs = 0.f;
        row_values<D>(xr, th, thT, d, S, ll, lane, [&](int s, float v) {
          v *= msk;
          cr[s] = v;
          rs += v;
          pww[s] = fmaf(wm, v, pww[s]);
        });
        rs = warp_sum(rs);
        if (lane == 0) corerow[m] = rs;
      } else {
        row_values<D>(xr, th, thT, d, S, ll, lane,
                      [&](int s, float v) { pcw[s] += v * msk; });
      }
    } else if (is_core) {
      for (int s = lane; s < S; s += 32) cr[s] = 0.f;
      if (lane == 0) corerow[m] = 0.f;
    }
    if (is_core) {
      for (int s = S + lane; s < s_pad; s += 32) cr[s] = 0.f;
    }
  });

  // 3. the CTA's partials (column s is read and written by one thread),
  //    then the cluster's sums, CTA r writing columns [r * chunk, (r + 1) * chunk)
  for (int s = tid; s < S; s += kThreads) {
    csum[s] = warps_sum(pc, S, s);
    wsum[s] = warps_sum(pw, S, s);
  }
  cl.sync();
  const int chunk = ceil_div(s_pad, C);
  const int s_end = min(s_pad, (rank + 1) * chunk);
  for (int s = rank * chunk + tid; s < s_end; s += kThreads) {
    colsum[s] = s < S ? cluster_sum(cl, csum, C, s) : 0.f;
    wcore[s] = s < S ? cluster_sum(cl, wsum, C, s) : 0.f;
  }
  cl.sync();  // peers are done with csum and wsum
}

template <int D>
int launch(const void* xin, const void* z, const void* mu, const void* linv,
           const void* w, const void* sc, void* colsum, void* core, void* corerow,
           void* wcore, int R, int d, int S, int s_pad, int M_pad, int use_beta,
           int cluster, void* stream) {
  static LaunchState state[kMaxDevices] = {};
  return (int)launch_cluster(
      logreg_shard_partials_kernel<D>, state, cluster,
      smem_floats(R, d, S, M_pad, cluster) * sizeof(float), stream,
      (const float*)xin, (const float*)z, (const float*)mu, (const float*)linv,
      (const float*)w, (const float*)sc, (float*)colsum, (float*)core,
      (float*)corerow, (float*)wcore, R, d, S, s_pad, M_pad, use_beta);
}

}  // namespace

extern "C" {

// Dynamic shared memory of each CTA of one launch, in bytes.
long long logreg_shard_partials_smem_bytes(int R, int d, int S, int M_pad, int cluster) {
  return (long long)(smem_floats(R, d, S, M_pad, cluster) * sizeof(float));
}

// Launches one step's partials as one cluster of `cluster` CTAs on
// `stream`; returns the cudaError_t of the launch (0 on success).
// Allocates nothing and does not synchronise.
int logreg_shard_partials(const void* xin, const void* z, const void* mu,
                          const void* linv, const void* w, const void* sc,
                          void* colsum, void* core, void* corerow, void* wcore,
                          int R, int d, int S, int s_pad, int M_pad, int use_beta,
                          int cluster, void* stream) {
  switch (theta_regs(d, S)) {
#define BCORES_CASE(D)                                                              \
  case D:                                                                           \
    return launch<D>(xin, z, mu, linv, w, sc, colsum, core, corerow, wcore, R, d, S, \
                     s_pad, M_pad, use_beta, cluster, stream);
    BCORES_CASE(0) BCORES_CASE(4) BCORES_CASE(8) BCORES_CASE(12) BCORES_CASE(16)
#undef BCORES_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The launch floor of one launch at these shapes: an empty kernel of the
// same cluster geometry and shared memory, with both cluster barriers.
int logreg_shard_partials_floor(int R, int d, int S, int M_pad, int cluster, void* stream) {
  static LaunchState state[kMaxDevices] = {};
  return (int)launch_cluster(cluster_floor_kernel, state, cluster,
                             smem_floats(R, d, S, M_pad, cluster) * sizeof(float), stream, 0);
}

}  // extern "C"
