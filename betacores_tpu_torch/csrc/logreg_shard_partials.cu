// The shard-local, uncentred half of one sharded refinement step of the
// beta-Cores build, in one launch.
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
// What bounds it: nothing on the card's roofline. At the sharded headline
// shapes (328 packed rows, d = 10, S = 100 on a (1, 1) mesh) a step is ~33k
// likelihood values, ~0.4 MFLOP and a 51 KB core block written once; 500
// such steps run back to back, each depending on the last through the
// weights. The step is bound by launch and dependency latency, so ONE block
// does the whole step, as the single-device step kernel does. theta and
// the per-warp partial sums stay in shared memory; each warp walks its rows
// in a fixed order and the partials are summed over warps in a fixed order,
// with no atomics, so the result is deterministic. core is written straight
// to device memory, coalesced along the sample axis, and never read back:
// w . core is accumulated per warp while the row is in registers.
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

#include "logreg_common.cuh"

namespace {

using bcores::logreg_val;
using bcores::warp_sum;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

size_t smem_floats(int d, int S) {
  // thT + per-warp subsample column sums + per-warp w . core partials
  // + per-warp x row
  return (size_t)d * S + 2 * (size_t)kWarps * S + (size_t)kWarps * (d + 1);
}

__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  float* thT = smem;                   // (d, S): theta transposed
  float* pc = thT + d * S;             // (kWarps, S): subsample column sums
  float* pw = pc + kWarps * S;         // (kWarps, S): w . core partials
  float* xrow = pw + kWarps * S;       // (kWarps, d+1): one row of xin

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = d + 1;
  const int n_sub_pad = R - M_pad;

  // 1. theta = z @ L^-1 + mu, transposed so that lanes walking the sample
  //    axis read consecutive words
  for (int e = tid; e < S * d; e += kThreads) {
    const int s = e / d, j = e - s * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(z[s * d + k], linv[k * d + j], acc);
    thT[j * S + s] = acc + mu[j];
  }
  for (int e = tid; e < 2 * kWarps * S; e += kThreads) pc[e] = 0.f;  // pc and pw
  __syncthreads();

  // 2. one warp per row, lanes over samples
  const float beta = sc[0];
  float* xr = xrow + warp * D1;
  float* pcw = pc + warp * S;
  float* pww = pw + warp * S;
  for (int r = warp; r < R; r += kWarps) {
    for (int j = lane; j < D1; j += 32) xr[j] = xin[(size_t)r * D1 + j];
    __syncwarp();
    const float msk = xr[d];
    const bool is_core = r >= n_sub_pad;  // warp-uniform
    const int m = r - n_sub_pad;
    float* cr = core + (size_t)(is_core ? m : 0) * s_pad;
    if (msk != 0.f) {  // warp-uniform branch
      const float wm = is_core ? w[m] : 0.f;
      float rs = 0.f;
      for (int s = lane; s < S; s += 32) {
        float dot = 0.f;
        for (int j = 0; j < d; ++j) dot = fmaf(xr[j], thT[j * S + s], dot);
        const float v = logreg_val(-dot, beta, use_beta) * msk;
        if (is_core) {
          cr[s] = v;
          rs += v;
          pww[s] = fmaf(wm, v, pww[s]);
        } else {
          pcw[s] += v;
        }
      }
      if (is_core) {
        rs = warp_sum(rs);
        if (lane == 0) corerow[m] = rs;
      }
    } else if (is_core) {
      for (int s = lane; s < S; s += 32) cr[s] = 0.f;
      if (lane == 0) corerow[m] = 0.f;
    }
    if (is_core) {
      for (int s = S + lane; s < s_pad; s += 32) cr[s] = 0.f;
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. fixed-order sums over the warps, one thread per sample column
  for (int s = tid; s < s_pad; s += kThreads) {
    float cs = 0.f, wc = 0.f;
    if (s < S) {
      for (int q = 0; q < kWarps; ++q) {
        cs += pc[q * S + s];
        wc += pw[q * S + s];
      }
    }
    colsum[s] = cs;
    wcore[s] = wc;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes.
long long logreg_shard_partials_smem_bytes(int d, int S) {
  return (long long)(smem_floats(d, S) * sizeof(float));
}

// Launches one step's partials on `stream`; returns the cudaError_t of the
// launch (0 on success). Allocates nothing and does not synchronise.
int logreg_shard_partials(const void* xin, const void* z, const void* mu,
                          const void* linv, const void* w, const void* sc,
                          void* colsum, void* core, void* corerow, void* wcore,
                          int R, int d, int S, int s_pad, int M_pad, int use_beta,
                          void* stream) {
  const size_t smem = smem_floats(d, S) * sizeof(float);
  static size_t smem_opted[bcores::kMaxDevices] = {};
  const cudaError_t err =
      bcores::ensure_smem(logreg_shard_partials_kernel, smem, smem_opted);
  if (err != cudaSuccess) return (int)err;
  logreg_shard_partials_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xin, (const float*)z, (const float*)mu, (const float*)linv,
      (const float*)w, (const float*)sc, (float*)colsum, (float*)core,
      (float*)corerow, (float*)wcore, R, d, S, s_pad, M_pad, use_beta);
  return (int)cudaGetLastError();
}

}  // extern "C"
