// One whole projected-Adam refinement step of the incremental beta-Cores
// build, in one launch.
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
// What bounds it: nothing on the card's roofline. At the main path's shapes
// (328 rows, d = 10, S = 100) a step is ~33k likelihood values and ~1 MFLOP,
// and 500 such steps run back to back, each depending on the last through
// the weights. The step is bound by launch and dependency latency.
// The design answers that with ONE block that does the whole step: one
// launch per step, no intermediate in device memory, every reduction in
// shared memory, no atomics (the sums run in a fixed order, so the result
// is deterministic). theta, the per-warp column sums and the centred
// coreset rows stay resident in shared memory; the coreset block is
// M_pad * S floats (51 KB at M_pad = 128, S = 100), so the block opts in to
// more than 48 KB of dynamic shared memory.
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

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// utils/opt.py::nn_adam's constants; 1-b is formed in double and rounded
// once, as the reference's Python-float arithmetic does
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kOneMinusB2 = (float)(1.0 - 0.999);

__device__ __forceinline__ float softplus(float m) {
  return fmaxf(m, 0.f) + log1pf(expf(-fabsf(m)));
}

__device__ __forceinline__ float logreg_val(float m, float beta, int use_beta) {
  if (!use_beta) return -softplus(m);
  const float sp = softplus(m), sn = softplus(-m);
  return (beta + 1.f) / beta * expf(-beta * sp)
         - expf(-(beta + 1.f) * sp) - expf(-(beta + 1.f) * sn);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_floats(int d, int S, int M_pad) {
  // thT + per-warp column sums + per-warp value row + resid + per-warp x row
  // + centred coreset block
  return (size_t)d * S + 2 * (size_t)kWarps * S + S
         + (size_t)kWarps * (d + 1) + (size_t)M_pad * S;
}

__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  float* thT = smem;                    // (d, S): theta transposed
  float* part = thT + d * S;            // (kWarps, S): subsample column sums
  float* vals = part + kWarps * S;      // (kWarps, S): one row's values
  float* resid = vals + kWarps * S;     // (S)
  float* xrow = resid + S;              // (kWarps, d+1): one row of xin
  float* core = xrow + kWarps * (d + 1);  // (M_pad, S): centred coreset rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = d + 1;
  const int n_sub_pad = R - M_pad;

  // 1. theta = z @ L^-1 + mu, stored transposed so that lanes walking the
  //    sample axis read consecutive words
  for (int e = tid; e < S * d; e += kThreads) {
    const int s = e / d, j = e - s * d;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(z[s * d + k], linv[k * d + j], acc);
    thT[j * S + s] = acc + mu[j];
  }
  for (int e = tid; e < kWarps * S; e += kThreads) part[e] = 0.f;
  __syncthreads();

  // 2. one warp per row, lanes over samples
  const float beta = sc[0];
  float* xr = xrow + warp * D1;
  float* vr = vals + warp * S;
  float* pr = part + warp * S;
  for (int r = warp; r < R; r += kWarps) {
    for (int j = lane; j < D1; j += 32) xr[j] = xin[(size_t)r * D1 + j];
    __syncwarp();
    const float msk = xr[d];
    const bool is_core = r >= n_sub_pad;
    float* cr = core + (size_t)(r - n_sub_pad) * S;
    if (msk != 0.f) {  // warp-uniform branch
      float rs = 0.f;
      for (int s = lane; s < S; s += 32) {
        float dot = 0.f;
        for (int j = 0; j < d; ++j) dot = fmaf(xr[j], thT[j * S + s], dot);
        const float v = logreg_val(-dot, beta, use_beta);
        vr[s] = v;  // each lane re-reads only the columns it wrote
        rs += v;
      }
      const float mean = warp_sum(rs) / (float)S;
      if (is_core) {
        for (int s = lane; s < S; s += 32) cr[s] = (vr[s] - mean) * msk;
      } else {
        for (int s = lane; s < S; s += 32) pr[s] += (vr[s] - mean) * msk;
      }
    } else if (is_core) {
      for (int s = lane; s < S; s += 32) cr[s] = 0.f;
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. resid = scaling * tsum - w . core, one thread per sample column
  const float scaling = sc[1];
  for (int s = tid; s < S; s += kThreads) {
    float ts = 0.f;
    for (int q = 0; q < kWarps; ++q) ts += part[q * S + s];
    float wc = 0.f;
    for (int m = 0; m < M_pad; ++m) wc = fmaf(w[m], core[(size_t)m * S + s], wc);
    resid[s] = scaling * ts - wc;
  }
  __syncthreads();

  // 4. g_m = -core_m . resid / S and projected Adam, one warp per slot.
  //    A padded slot has a zero core row, so g = 0 and its w, m1, m2 stay 0.
  const float lr = sclr[0], bc1 = sclr[1], bc2 = sclr[2];
  for (int m = warp; m < M_pad; m += kWarps) {
    float acc = 0.f;
    for (int s = lane; s < S; s += 32) acc = fmaf(core[(size_t)m * S + s], resid[s], acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const float g = -acc / (float)S;
      const float a = kB1 * m1[m] + kOneMinusB1 * g;
      const float b = kB2 * m2[m] + kOneMinusB2 * g * g;
      const float wn = w[m] - lr * (a / bc1) / (kEps + sqrtf(b / bc2));
      w_out[m] = fmaxf(wn, 0.f);
      m1_out[m] = a;
      m2_out[m] = b;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes.
long long logreg_adam_step_smem_bytes(int d, int S, int M_pad) {
  return (long long)(smem_floats(d, S, M_pad) * sizeof(float));
}

// Launches one step on `stream`; returns the cudaError_t of the launch
// (0 on success). Allocates nothing and does not synchronise.
int logreg_adam_step(const void* xin, const void* z, const void* mu,
                     const void* linv, const void* w, const void* m1,
                     const void* m2, const void* sc, const void* sclr,
                     void* w_out, void* m1_out, void* m2_out,
                     int R, int d, int S, int M_pad, int use_beta,
                     void* stream) {
  const size_t smem = smem_floats(d, S, M_pad) * sizeof(float);
  // the opt-in above 48 KB is a per-device attribute of the kernel
  constexpr int kMaxDevices = 64;
  static size_t smem_opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > smem_opted[dev]) {
    err = cudaFuncSetAttribute(logreg_adam_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_opted[dev] = smem;
  }
  logreg_adam_step_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xin, (const float*)z, (const float*)mu,
      (const float*)linv, (const float*)w, (const float*)m1,
      (const float*)m2, (const float*)sc, (const float*)sclr,
      (float*)w_out, (float*)m1_out, (float*)m2_out, R, d, S, M_pad, use_beta);
  return (int)cudaGetLastError();
}

}  // extern "C"
