// One whole projected-Adam refinement step of the incremental beta-Cores
// build, in one launch of one thread-block cluster.
//
// Replaces the TPU kernel
//   betacores_tpu/ops/pallas_kernels.py::_logreg_adam_step_kernel
// (wrapper logreg_adam_step_fused). Same function, not the same blocking:
//   1. theta = mu + z @ L^-1                       (S x d)
//   2. margins m = -x . theta over the packed rows [subsample; coreset
//      buffer], the (beta-)log-likelihood transform, centring over the S
//      true sample columns, and the row mask
//   3. tsum = column sum of the subsample rows, wcore = w . core,
//      resid = scaling * tsum - wcore
//   4. g = -core . resid / S and the projected-Adam update (clamped >= 0)
//
// What bounds it on this card: not the roofline. At the main path's shapes
// (328 packed rows, ~260 live, d = 10, S = 100, M_pad = 128) a step is
// ~1.3 MFLOP and ~22 KB moved, 0.02 us at the float32 peak; 500 such steps
// run back to back, each depending on the last through the weights. What
// is left is the launch floor (one cluster launch and two cluster
// barriers, a few us) and the step's own critical chain.
// The design shortens that chain: ONE cluster of C CTAs (C from the
// wrapper, ops/kernels.py::cluster_size) does the whole step.
//   - The packed rows are split across the CTAs, never the sample axis,
//     interleaved (bcores::RowSplit): each row's centring mean stays in
//     one warp, and the CTA that owns a buffer slot keeps that slot's
//     centred core row in its own shared memory and does its gradient and
//     Adam update.
//   - Every CTA forms theta itself (~10 kFLOP); a lane keeps its sample
//     columns' theta in registers (d <= 16, S <= 128; shared memory
//     otherwise), and the CTA's rows are staged in shared memory, 64 at a
//     time, before the warps walk them, so no global load sits in a
//     warp's row chain.
//   - Each CTA leaves its partial subsample column sums and w . core in
//     its shared memory; after a cluster barrier every CTA reads all C
//     partials through distributed shared memory in rank order 0..C-1 and
//     forms the same resid. A second barrier keeps each CTA's shared
//     memory alive until its peers have read it. No atomics: the same
//     inputs give the same bits on every launch.
//
// Layout (all float32, row-major, contiguous):
//   xin  (R, d+1)  rows [x | mask]: R = n_sub_pad + M_pad, subsample first
//   z    (>= S, d) pre-drawn noise; rows beyond S are ignored
//   mu   (d)       Laplace mode;  linv (d, d) = L^-1
//   w, m1, m2 (M_pad)  Adam state; padded slots must hold 0 and stay 0
//   sc   (2)  = [beta, sum_scaling];  sclr (3) = [lr, 1-b1^t, 1-b2^t]
// The scalars stay in device memory, read by the kernel, so the host
// never reads a device value between steps.

#include <cuda_runtime.h>

#include <algorithm>

#include "logreg_common.cuh"

namespace {

using namespace bcores;

// utils/opt.py::nn_adam's constants; 1-b is formed in double and rounded
// once, as the reference's Python-float arithmetic does
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kOneMinusB2 = (float)(1.0 - 0.999);

size_t smem_floats(int R, int d, int S, int M_pad, int C) {
  // thT + per-warp column sums + per-warp value row + a batch of the
  // CTA's rows + the centred rows of its slots + their w, m1, m2
  const int n_core = ceil_div(M_pad, C);
  const int n_rows = std::min(kStageRows, ceil_div(R - M_pad, C) + n_core);
  return (size_t)d * S + 2 * (size_t)kWarps * S + (size_t)n_rows * (d + 1)
         + (size_t)n_core * (S + 3);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
logreg_adam_step_kernel(const float* __restrict__ xin,
                        const float* __restrict__ z,
                        const float* __restrict__ mu,
                        const float* __restrict__ linv,
                        const float* __restrict__ w,
                        const float* __restrict__ m1,
                        const float* __restrict__ m2,
                        const float* __restrict__ sc,
                        const float* __restrict__ sclr,
                        float* __restrict__ w_out,
                        float* __restrict__ m1_out,
                        float* __restrict__ m2_out,
                        int R, int d, int S, int M_pad, int use_beta) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = d + 1;
  const int n_sub_pad = R - M_pad;
  const RowSplit sp((int)cl.block_rank(), C, n_sub_pad, M_pad);

  extern __shared__ float smem[];
  const int n_core_max = ceil_div(M_pad, C);
  float* thT = smem;                    // (d, S): theta transposed
  float* part = thT + d * S;            // (kWarps, S): subsample column sums
  float* vals = part + kWarps * S;      // (kWarps, S): one row's values
  float* xs = vals + kWarps * S;        // (<= kStageRows, d+1): a batch of rows
  float* core = xs + min(kStageRows, ceil_div(n_sub_pad, C) + n_core_max) * D1;
  float* ws = core + n_core_max * S;    // (n_core): w, m1, m2 of the CTA's slots
  float* m1s = ws + n_core_max;
  float* m2s = m1s + n_core_max;
  // after the row pass: the CTA's partials, read by its peers, in place
  float* tsum = part;                   // (S): subsample column sums
  float* wsum = vals;                   // (S): w . core
  float* resid = vals + S;              // (S)

  // 1. the first batch of rows and the slots' Adam state copied in the
  //    background while theta is formed; the scalars read up front
  stage_rows_async(xin, D1, sp, 0, xs);
  stage_slots_async(w, sp, ws);
  stage_slots_async(m1, sp, m1s);
  stage_slots_async(m2, sp, m2s);
  const Likelihood ll(sc[0], use_beta);
  const float scaling = sc[1];
  const float lr = sclr[0], bc1 = sclr[1], bc2 = sclr[2];
  stage_theta<D>(z, mu, linv, d, S, thT);
  for (int e = tid; e < kWarps * S; e += kThreads) part[e] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  Theta<D> th;
  th.load(thT, d, S, lane);

  // 2. one warp per row, lanes over samples
  float* vr = vals + warp * S;
  float* pr = part + warp * S;
  for_each_row(xin, D1, sp, xs, [&](int i, const float* xr) {
    const float msk = xr[d];
    const bool is_core = i >= sp.n_sub;
    float* cr = core + (size_t)(is_core ? i - sp.n_sub : 0) * S;
    if (msk != 0.f) {  // warp-uniform branch
      float rs = 0.f;
      row_values<D>(xr, th, thT, d, S, ll, lane, [&](int s, float v) {
        vr[s] = v;  // each lane re-reads only the columns it wrote
        rs += v;
      });
      const float mean = warp_sum(rs) / (float)S;
      if (is_core) {
        for (int s = lane; s < S; s += 32) cr[s] = (vr[s] - mean) * msk;
      } else {
        for (int s = lane; s < S; s += 32) pr[s] += (vr[s] - mean) * msk;
      }
    } else if (is_core) {
      for (int s = lane; s < S; s += 32) cr[s] = 0.f;
    }
  });

  // 3. the CTA's partials (column s is read and written by one thread),
  //    then resid = scaling * tsum - w . core over the cluster, the same
  //    in every CTA
  for (int s = tid; s < S; s += kThreads) {
    float wc = 0.f;
    for (int j = 0; j < sp.n_core; ++j) wc = fmaf(ws[j], core[(size_t)j * S + s], wc);
    tsum[s] = warps_sum(part, S, s);
    wsum[s] = wc;
  }
  cl.sync();
  for (int s = tid; s < S; s += kThreads)
    resid[s] = scaling * cluster_sum(cl, tsum, C, s) - cluster_sum(cl, wsum, C, s);
  cl.sync();  // peers are done with tsum and wsum; resid is complete

  // 4. g_m = -core_m . resid / S and projected Adam for the CTA's slots,
  //    one warp per slot. A padded slot has a zero core row, so g = 0 and
  //    its w, m1, m2 stay 0.
  for (int j = warp; j < sp.n_core; j += kWarps) {
    float acc = 0.f;
    for (int s = lane; s < S; s += 32) acc = fmaf(core[(size_t)j * S + s], resid[s], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const int m = sp.slot(j);
      const float g = -acc / (float)S;
      const float a = kB1 * m1s[j] + kOneMinusB1 * g;
      const float b = kB2 * m2s[j] + kOneMinusB2 * g * g;
      const float wn = ws[j] - lr * (a / bc1) / (kEps + sqrtf(b / bc2));
      w_out[m] = fmaxf(wn, 0.f);
      m1_out[m] = a;
      m2_out[m] = b;
    }
  }
}

template <int D>
int launch(const void* xin, const void* z, const void* mu, const void* linv,
           const void* w, const void* m1, const void* m2, const void* sc,
           const void* sclr, void* w_out, void* m1_out, void* m2_out, int R, int d,
           int S, int M_pad, int use_beta, int cluster, void* stream) {
  static LaunchState state[kMaxDevices] = {};
  return (int)launch_cluster(
      logreg_adam_step_kernel<D>, state, cluster,
      smem_floats(R, d, S, M_pad, cluster) * sizeof(float), stream,
      (const float*)xin, (const float*)z, (const float*)mu, (const float*)linv,
      (const float*)w, (const float*)m1, (const float*)m2, (const float*)sc,
      (const float*)sclr, (float*)w_out, (float*)m1_out, (float*)m2_out, R, d, S,
      M_pad, use_beta);
}

}  // namespace

extern "C" {

// Dynamic shared memory of each CTA of one launch, in bytes.
long long logreg_adam_step_smem_bytes(int R, int d, int S, int M_pad, int cluster) {
  return (long long)(smem_floats(R, d, S, M_pad, cluster) * sizeof(float));
}

// Launches one step as one cluster of `cluster` CTAs on `stream`; returns
// the cudaError_t of the launch (0 on success). Allocates nothing and does
// not synchronise.
int logreg_adam_step(const void* xin, const void* z, const void* mu,
                     const void* linv, const void* w, const void* m1,
                     const void* m2, const void* sc, const void* sclr,
                     void* w_out, void* m1_out, void* m2_out,
                     int R, int d, int S, int M_pad, int use_beta, int cluster,
                     void* stream) {
  switch (theta_regs(d, S)) {
#define BCORES_CASE(D)                                                                \
  case D:                                                                             \
    return launch<D>(xin, z, mu, linv, w, m1, m2, sc, sclr, w_out, m1_out, m2_out, R, \
                     d, S, M_pad, use_beta, cluster, stream);
    BCORES_CASE(0) BCORES_CASE(4) BCORES_CASE(8) BCORES_CASE(12) BCORES_CASE(16)
#undef BCORES_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The launch floor of one step at these shapes: an empty kernel of the
// same cluster geometry and shared memory, with both cluster barriers.
int logreg_adam_step_floor(int R, int d, int S, int M_pad, int cluster, void* stream) {
  static LaunchState state[kMaxDevices] = {};
  return (int)launch_cluster(cluster_floor_kernel, state, cluster,
                             smem_floats(R, d, S, M_pad, cluster) * sizeof(float), stream, 0);
}

}  // extern "C"
