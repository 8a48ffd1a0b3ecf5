// Centred K-class softmax (beta-)log-likelihood projection, in one pass.
//
// Replaces the TPU kernel
//   betacores_tpu/ops/pallas_kernels.py::_multiclass_kernel
// (wrapper multiclass_projection_fused). Same function, not the same
// blocking: the TPU's 128-lane padding of S is a layout, not part of it.
// For every row n = [x_n | y_n] and every sample s:
//   logit_k = x_n . theta_s[k]        (K logits, theta packed (K, d))
//   lse     = max_k + log(sum_k exp(logit_k - max_k))
//   lp_y    = logit_{y_n} - lse       (the label compared as a float with k)
//   v       = lp_y                                          (log-likelihood)
//   v       = (b+1)/b exp(b lp_y) - sum_k exp((1+b)(logit_k - lse))  (beta)
//   out[n, s] = v - mean_s v          (mean over the S true samples)
//
// What bounds it: at the main path's shape (N = 2^20 rows, d = 10, K = 5,
// S = 100) it reads 46 MB and writes 419 MB, and does about 5.2 G FMAs and
// 1.2 G exp/log (each of which, without fast math, is a short instruction
// sequence). Writing (N, S) is about 0.14 ms at the card's 3.35 TB/s; the
// arithmetic is several times more instructions than that, so the kernel
// is expected to be bound by instruction issue, not by device memory. The
// design keeps everything but the output out of device memory, which the
// plain composition cannot: it materialises (N, S, K) logits and
// log-probabilities (2 GB each at the main shape).
//
// Design: theta is staged once per block in shared memory as (d, K, S),
// so lanes walking the sample axis read consecutive words. One warp per
// row: lane j holds x_j in a register (d <= 32) and the warp broadcasts it
// with a shuffle; the K logits of one (row, s) live in registers (K is a
// template parameter, 2..16); the row's values go to a per-warp row of
// shared memory, the row mean is a warp-shuffle sum, and the centred row is
// written with consecutive lanes on consecutive addresses. beta is read
// from device memory, so the host never reads a device value.
//
// Layout (float32, row-major, contiguous):
//   z      (N, d+1)  rows [x | y], y a float class index
//   thetas (S, K*d)  packed row-major (K, d)
//   beta   (1)
//   out    (N, S)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// limits of the design (K logits in registers, x_j in lane j); the
// wrapper in ops/kernels.py repeats them
constexpr int kMaxK = 16;
constexpr int kMaxD = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

size_t smem_floats(int d, int K, int S) {
  // theta as (d, K, S) + one value row per warp
  return (size_t)d * K * S + (size_t)kWarps * S;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
multiclass_projection_kernel(const float* __restrict__ z,
                             const float* __restrict__ thetas,
                             const float* __restrict__ beta_p,
                             float* __restrict__ out,
                             long long N, int d, int S, int use_beta) {
  extern __shared__ float smem[];
  float* th = smem;                       // (d, K, S)
  float* vals = th + (size_t)d * K * S;   // (kWarps, S)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Kd = K * d;
  // stage theta: coalesced reads of the packed (S, K, d) rows
  for (int e = tid; e < S * Kd; e += kThreads) {
    const int s = e / Kd, kj = e - s * Kd;
    const int k = kj / d, j = kj - k * d;
    th[((size_t)j * K + k) * S + s] = thetas[e];
  }
  __syncthreads();

  const float beta = beta_p[0];
  const float b1 = 1.f + beta;               // (1 + beta) of the mass term
  const float coef = (beta + 1.f) / beta;    // (beta + 1) / beta
  const int D1 = d + 1;
  float* vr = vals + (size_t)warp * S;
  const long long stride = (long long)gridDim.x * kWarps;

  for (long long row = (long long)blockIdx.x * kWarps + warp; row < N; row += stride) {
    const float* zr = z + row * D1;
    const float xv = lane < d ? zr[lane] : 0.f;
    const float yv = zr[d];
    float rs = 0.f;
    // the trip count is the same for every lane (shuffles need the whole
    // warp); lanes past S compute on column 0 and store nothing
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < S;
      const float* tcol = th + (live ? s : 0);
      float lg[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lg[k] = 0.f;
      for (int j = 0; j < d; ++j) {
        const float xj = __shfl_sync(kFull, xv, j);
        const float* tj = tcol + (size_t)j * K * S;
#pragma unroll
        for (int k = 0; k < K; ++k) lg[k] = fmaf(xj, tj[k * S], lg[k]);
      }
      float mx = lg[0];
#pragma unroll
      for (int k = 1; k < K; ++k) mx = fmaxf(mx, lg[k]);
      float se = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) se += expf(lg[k] - mx);
      const float lse = mx + logf(se);
      float py = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) py += (yv == (float)k) ? lg[k] : 0.f;
      const float lp_y = py - lse;
      float v = lp_y;
      if (use_beta) {
        float mass = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) mass += expf(b1 * (lg[k] - lse));
        v = coef * expf(beta * lp_y) - mass;
      }
      if (live) {
        vr[s] = v;  // each lane re-reads only the columns it wrote
        rs += v;
      }
    }
    const float mean = warp_sum(rs) / (float)S;
    float* orow = out + row * S;
    for (int s = lane; s < S; s += 32) orow[s] = vr[s] - mean;
  }
}

template <int K>
int launch(const float* z, const float* thetas, const float* beta, float* out,
           long long N, int d, int S, int use_beta, cudaStream_t stream) {
  const size_t smem = smem_floats(d, K, S) * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(multiclass_projection_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, multiclass_projection_kernel<K>, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // enough blocks to fill the card once; each warp then walks its rows
  const long long want = (N + kWarps - 1) / kWarps;
  const long long cap = (long long)n_sm * per_sm;
  const int grid = (int)(want < cap ? want : cap);
  multiclass_projection_kernel<K><<<grid, kThreads, smem, stream>>>(
      z, thetas, beta, out, N, d, S, use_beta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes.
long long multiclass_projection_smem_bytes(int d, int K, int S) {
  return (long long)(smem_floats(d, K, S) * sizeof(float));
}

// Launches one projection on `stream`; returns the cudaError_t of the
// launch (0 on success). Allocates nothing and does not synchronise.
// Needs 1 <= N, 1 <= d <= 32, 2 <= K <= 16, 1 <= S.
int multiclass_projection(const void* z, const void* thetas, const void* beta,
                          void* out, long long N, int d, int K, int S,
                          int use_beta, void* stream) {
  if (N < 1 || d < 1 || d > kMaxD || S < 1) return (int)cudaErrorInvalidValue;
  const float* zp = (const float*)z;
  const float* tp = (const float*)thetas;
  const float* bp = (const float*)beta;
  float* op = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
#define BC_CASE(k) \
    case k: return launch<k>(zp, tp, bp, op, N, d, S, use_beta, st);
    BC_CASE(2) BC_CASE(3) BC_CASE(4) BC_CASE(5) BC_CASE(6) BC_CASE(7)
    BC_CASE(8) BC_CASE(9) BC_CASE(10) BC_CASE(11) BC_CASE(12) BC_CASE(13)
    BC_CASE(14) BC_CASE(15) BC_CASE(16)
#undef BC_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
