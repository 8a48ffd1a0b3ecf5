// Device code shared by the logistic-regression step kernels
// (logreg_adam_step.cu, logreg_shard_partials.cu): the likelihood
// transform, and the row pass both run as ONE thread-block cluster of C
// CTAs per step: the row split, theta staging, the value loop, the
// reduction over the cluster through distributed shared memory, and the
// cluster launch itself.
//
// The transform is the one implementation of the TPU kernels'
// betacores_tpu/ops/pallas_kernels.py::_logreg_vals: softplus as
// max(m, 0) + log1p(exp(-|m|)), expf/log1pf without fast math.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace bcores {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;   // 9..16 need the non-portable opt-in
// theta stays in registers for d <= kMaxRegD (padded to a multiple of 4)
// and S <= 32 * kMaxPasses; other shapes read it from shared memory
constexpr int kMaxRegD = 16, kMaxPasses = 4;
// rows staged in shared memory at a time (4 per warp)
constexpr int kStageRows = 64;

// The (beta-)log-likelihood of one margin m = -x . theta, with the
// beta-mode constants formed once per launch. softplus(m) and softplus(-m)
// share log1p(exp(-|m|)), so it is formed once.
struct Likelihood {
  float beta, b1, cb;  // beta, beta + 1, (beta + 1) / beta
  int use_beta;
  __device__ Likelihood(float beta_, int use_beta_)
      : beta(beta_), b1(beta_ + 1.f), cb((beta_ + 1.f) / beta_), use_beta(use_beta_) {}
  __device__ __forceinline__ float operator()(float m) const {
    const float l = log1pf(expf(-fabsf(m)));
    const float sp = fmaxf(m, 0.f) + l;
    if (!use_beta) return -sp;
    const float sn = fmaxf(-m, 0.f) + l;
    return cb * expf(-beta * sp) - expf(-b1 * sp) - expf(-b1 * sn);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The row split, interleaved: subsample row r belongs to CTA r mod C and
// buffer slot m (packed row n_sub_pad + m) to CTA m mod C, so the CTA that
// owns a slot owns its core row. ops/kernels.py::cluster_rows mirrors it.
// A CTA's local rows are its subsample rows, then its slots, in order.
struct RowSplit {
  int rank, C, n_sub_pad, n_sub, n_core;
  __device__ RowSplit(int rank_, int C_, int n_sub_pad_, int M_pad)
      : rank(rank_), C(C_), n_sub_pad(n_sub_pad_),
        n_sub(rank_ < n_sub_pad_ ? ceil_div(n_sub_pad_ - rank_, C_) : 0),
        n_core(rank_ < M_pad ? ceil_div(M_pad - rank_, C_) : 0) {}
  __device__ int rows() const { return n_sub + n_core; }
  __device__ int slot(int j) const { return rank + j * C; }   // j-th local slot
  __device__ int row(int i) const {                          // i-th local row
    return i < n_sub ? rank + i * C : n_sub_pad + slot(i - n_sub);
  }
};

// theta = z @ L^-1 + mu for the S sample columns, transposed to (d, S) so
// that lanes walking the sample axis read consecutive words. Every CTA of
// the cluster forms its own copy (d * d * S FMAs, ~10k at the main path).
template <int D>
__device__ __forceinline__ void stage_theta(const float* __restrict__ z,
                                            const float* __restrict__ mu,
                                            const float* __restrict__ linv,
                                            int d, int S, float* thT) {
  for (int e = threadIdx.x; e < S * d; e += kThreads) {
    const int s = e / d, j = e - s * d;
    float acc = 0.f;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        if (k < d) acc = fmaf(z[s * d + k], linv[k * d + j], acc);
    } else {
      for (int k = 0; k < d; ++k) acc = fmaf(z[s * d + k], linv[k * d + j], acc);
    }
    thT[j * S + s] = acc + mu[j];
  }
}

// A lane's theta columns s = lane + 32k in registers, zero beyond d and S
// (D > 0); with D == 0 the value loop reads theta from shared memory.
template <int D>
struct Theta {
  float v[kMaxPasses][D > 0 ? D : 1];
  __device__ __forceinline__ void load(const float* thT, int d, int S, int lane) {
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < kMaxPasses; ++k) {
        const int s = lane + 32 * k;
#pragma unroll
        for (int j = 0; j < D; ++j) v[k][j] = (s < S && j < d) ? thT[j * S + s] : 0.f;
      }
    }
  }
};

// Calls emit(s, v) for each of the lane's sample columns s < S (lane,
// lane + 32, ...), v = ll(-xr . theta_s). The
// dot product runs over j = 0..d-1 in order (the padding adds exact zeros).
template <int D, typename Emit>
__device__ __forceinline__ void row_values(const float* xr, const Theta<D>& th,
                                           const float* thT, int d, int S,
                                           const Likelihood& ll, int lane, Emit emit) {
  if constexpr (D > 0) {
    float x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = j < d ? xr[j] : 0.f;
#pragma unroll
    for (int k = 0; k < kMaxPasses; ++k) {
      const int s = lane + 32 * k;
      if (s < S) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) dot = fmaf(x[j], th.v[k][j], dot);
        emit(s, ll(-dot));
      }
    }
  } else {
    for (int s = lane; s < S; s += 32) {
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot = fmaf(xr[j], thT[j * S + s], dot);
      emit(s, ll(-dot));
    }
  }
}

// An asynchronous 4-byte copy from device to shared memory (cp.async):
// the thread goes on without waiting; cp_async_wait_all() then waits for
// all of its own copies, and a barrier publishes them to the CTA.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying the batch of the CTA's rows [x | mask] from local row
// `base` on (at most kStageRows rows) into `xs` (kStageRows, d+1).
__device__ __forceinline__ void stage_rows_async(const float* __restrict__ xin, int D1,
                                                 const RowSplit& sp, int base, float* xs) {
  const int n = min(kStageRows, sp.rows() - base) * D1;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / D1, j = e - i * D1;
    cp_async4(xs + e, xin + (size_t)sp.row(base + i) * D1 + j);
  }
}

// Starts copying src[slot] of the CTA's buffer slots into dst (n_core).
__device__ __forceinline__ void stage_slots_async(const float* __restrict__ src,
                                                  const RowSplit& sp, float* dst) {
  for (int j = threadIdx.x; j < sp.n_core; j += kThreads) cp_async4(dst + j, src + sp.slot(j));
}

// Walks the CTA's rows, one warp per row, calling row_fn(i, xr) for local
// row i. The caller has staged the first batch (stage_rows_async, waited
// and published by a barrier); later batches of kStageRows are staged
// here, each before any of its rows is processed, so no device-memory load
// sits in a warp's row chain. Ends with a barrier. A CTA without rows
// calls nothing, and reaches every barrier of its caller.
template <typename RowFn>
__device__ __forceinline__ void for_each_row(const float* __restrict__ xin, int D1,
                                             const RowSplit& sp, float* xs, RowFn row_fn) {
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < sp.rows(); base += kStageRows) {
    if (base > 0) {
      __syncthreads();  // the last batch is done with xs
      stage_rows_async(xin, D1, sp, base, xs);
      cp_async_wait_all();
      __syncthreads();
    }
    const int n = min(kStageRows, sp.rows() - base);
    for (int i = warp; i < n; i += kWarps) row_fn(base + i, xs + i * D1);
  }
  __syncthreads();
}

// Column s of the per-warp partial rows `part` (kWarps, S), summed over
// the warps in order.
__device__ __forceinline__ float warps_sum(const float* part, int S, int s) {
  float acc = 0.f;
  for (int q = 0; q < kWarps; ++q) acc += part[q * S + s];
  return acc;
}

// Column s of the C CTAs' partial rows `part` (the same shared-memory
// offset in each CTA), read through distributed shared memory and summed
// in rank order 0..C-1: every CTA that asks gets the same bits.
// All C loads are issued before the first add.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cl, float* part, int C, int s) {
  float v[kMaxCluster];
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c) v[c] = c < C ? cl.map_shared_rank(part, c)[s] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    if (c < C) acc += v[c];
  return acc;
}

// The launch floor: the kernels' cluster geometry, both cluster barriers,
// no work. (The argument, unused, keeps the launch's argument list
// non-empty.)
__global__ void __launch_bounds__(kThreads, 1) cluster_floor_kernel(int) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  cl.sync();
}

// Host side. Per kernel and device, the attributes set so far: the opt-in
// above 48 KB of dynamic shared memory, and clusters beyond 8 CTAs.
constexpr int kMaxDevices = 64;
struct LaunchState {
  size_t smem_opted;
  bool nonportable;
};

// Which theta path a shape takes: D > 0 (registers, d padded to D) or 0.
inline int theta_regs(int d, int S) {
  return (d <= kMaxRegD && S <= 32 * kMaxPasses) ? ceil_div(d, 4) * 4 : 0;
}

// Sets what `kernel` needs to launch as one cluster of `cluster` CTAs with
// `smem` bytes of dynamic shared memory each, then launches it on
// `stream`. Returns the first cudaError_t met (cudaSuccess when it was
// launched); a cluster the card refuses is an error, never retried.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), LaunchState (&state)[kMaxDevices],
                           int cluster, size_t smem, void* stream, Args... args) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  LaunchState& st = state[dev];
  if (smem > 48 * 1024 && smem > st.smem_opted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    st.smem_opted = smem;
  }
  if (cluster > 8 && !st.nonportable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    st.nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);   // the grid is exactly one cluster
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace bcores
