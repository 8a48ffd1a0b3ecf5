// Device code shared by the logistic-regression step kernels
// (logreg_adam_step.cu, logreg_shard_partials.cu): the likelihood
// transform, a warp sum, and the opt-in to more than 48 KB of dynamic
// shared memory.
//
// The transform is the one implementation of the TPU kernels'
// betacores_tpu/ops/pallas_kernels.py::_logreg_vals: softplus as
// max(m, 0) + log1p(exp(-|m|)), expf/log1pf without fast math.

#pragma once

#include <cuda_runtime.h>

namespace bcores {

__device__ __forceinline__ float softplus(float m) {
  return fmaxf(m, 0.f) + log1pf(expf(-fabsf(m)));
}

// The (beta-)log-likelihood of one margin m = -x . theta.
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

// Lets `kernel` launch with `smem` bytes of dynamic shared memory on the
// current device. The opt-in above 48 KB is a per-device attribute of the
// kernel, so `opted` (one slot per device, owned by the caller) remembers
// the largest size already set.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, size_t smem, size_t (&opted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace bcores
