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
// What bounds it: instruction issue and latency, not memory. At the main
// path's shape (N = 2^20 rows, d = 10, K = 5, S = 100) it reads 46 MB and
// writes 419 MB (0.14 ms at 3.35 TB/s; the write-only floor of this grid
// takes about as long), and each of the 104.9 M values takes K d = 50 FMAs,
// 2K + 2 one-MUFU transcendentals and the softmax's bookkeeping: about 120
// instructions a value in the value loop, 0.40 ms of issue on 132 SMs at
// 1.98 GHz. On an H100 it takes about twice that (PERF.md), most of it in
// the value loop: 7 of the 25 warps share one SM sub-partition, and each
// value is a long dependent chain; the row means and the centred store of
// each tile take the rest.
//
// Design:
//   - A thread owns one sample s and holds theta_s (K x D values, d padded
//     to an even D) in registers, so the logits take register operands
//     only. A row's x is read from shared memory as a broadcast in 16-byte
//     loads, one load for 4 K FMAs. Shapes with K (D + 3) > kRegBudget, or
//     D > kMaxRegD, or S > kThreads take the same kernel with D = 0: theta
//     in shared memory as (d, K, S), one load per K FMAs. The beta-mode
//     constants sit in shared memory, read where they are used, to keep
//     registers for theta.
//   - No idle lanes: a block of kThreads = 800 threads (25 warps) holds
//     G = floor(800 / S) groups of S threads (live = G S; 8 x 100 at
//     S = 100, every lane live). Thread t walks sample t mod S down rows
//     t / S, t / S + G, ... of each tile. With theta in shared memory the
//     walk is flat over the tile's (row, sample) pairs with all 800 live.
//   - Row tiles staged asynchronously: a tile is `rows` consecutive rows,
//     one contiguous span of z, copied with cp.async into a two-stage ring
//     (row stride W = d + 1 rounded up to 4, so x loads are aligned); the
//     next tile's copy overlaps this tile's arithmetic. A persistent grid
//     sized from the occupancy walks the tiles.
//   - Centring without atomics, in a fixed order: the tile's values go to
//     shared memory; thread r sums row r alone (from column r mod S on,
//     wrapping, in two chains), so the rows' sums run in parallel on
//     different banks; the centred tile is stored as one contiguous span
//     of out, consecutive threads on consecutive addresses. The same inputs
//     give the same bits on every launch. (A warp a row with a shuffle tree
//     was slower; a store warp that overlaps the stores with the next
//     tile was a little faster but made ptxas spill at the main shape.)
//   - Float32 on the CUDA cores, no tensor cores: the logits are a
//     (rows x d) (d x K S) product, but TF32 keeps about three decimal
//     digits, an error near 1e-2 at |x| |theta| ~ 10 against the 2e-5 the
//     kernel is held to, and at d = 10 the FMAs are not what bounds it. A
//     3xTF32 split is left for later.
//   - Transcendentals: every exponent is <= 0 (logit - max, logit - lse,
//     beta lp_y) and log's argument is in [1, K], where ex2.approx and
//     lg2.approx (one MUFU each) err by a few 1e-7 absolute, below the
//     rounding of the logits themselves; the exponent is formed as a
//     difference first and scaled by log2(e) after, so the argmax class
//     gets exp(0) = 1 exactly.
//
// Layout (float32, row-major, contiguous):
//   z      (N, d+1)  rows [x | y], y a float class index
//   thetas (S, K*d)  packed row-major (K, d)
//   beta   (1)       read by the kernel, so the host never reads a device value
//   out    (N, S)
//
// ops/kernels.py::mc_plan mirrors make_plan, and mc_work the walk.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 800;   // 25 warps
// limits of the kernel; the wrapper in ops/kernels.py repeats them
constexpr int kMaxK = 16;
constexpr int kMaxD = 32;
// theta in registers for K (D + 3) <= kRegBudget (theta, the K logits and
// two softmax temporaries a class) and D <= kMaxRegD: 25 warps a block put
// 7 on one SM sub-partition, which leaves 72 registers a thread; ptxas
// reports no spills for any instantiation under this rule
constexpr int kRegBudget = 65, kMaxRegD = 10;
// values a live thread computes per tile (sets the tile's rows)
constexpr int kTileValues = 16;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.69314718055994531f;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// How a launch covers the shapes: D the register path's padded d (0: theta
// in shared memory), `live` threads of a block working, `rows` per tile,
// and the dynamic shared memory in bytes.
struct Plan {
  int D, live, rows;
  long long smem;
};

Plan make_plan(int d, int K, int S, long long smem_limit) {
  const int D = d + (d & 1);
  const bool reg = S <= kThreads && D <= kMaxRegD && K * (D + 3) <= kRegBudget;
  Plan p;
  p.D = reg ? D : 0;
  p.live = reg ? (kThreads / S) * S : kThreads;
  // per row: two stages of x (W), of values (S) and of the row mean (1);
  // fixed: the beta-mode constants (4) and theta (d, K, S) when it is not in
  // registers
  const long long per_row = 2 * ((long long)round_up(d + 1, 4) + S + 1);
  const long long fixed = 4 + (reg ? 0 : (long long)d * K * S);
  const long long fit = (smem_limit / 4 - fixed) / per_row;
  long long rows = (long long)kTileValues * p.live / S;
  if (rows > fit) rows = fit;
  const int G = p.live / S;
  if (reg && rows >= G) rows -= rows % G;
  if (rows < 1) rows = 1;
  p.rows = (int)rows;
  p.smem = 4 * (fixed + per_row * rows);
  return p;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying rows [row0, row0 + nr) of z into dst (nr, W), the whole
// block taking part.
__device__ __forceinline__ void stage_rows(const float* __restrict__ z, long long row0, int nr,
                                           int D1, int W, float* dst) {
  const float* src = z + row0 * D1;
  const int n = nr * D1;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int i = e / D1;
    cp_async4(dst + i * W + (e - i * D1), src + e);
  }
}

// The (beta-)log-likelihood of one (row, sample) from its K logits. The
// beta-mode constants (beta log2(e), (1 + beta) log2(e), (beta + 1) / beta)
// are read from shared memory in one broadcast load where they are used,
// so they hold no registers across the value loop.
template <int K>
__device__ __forceinline__ float value(const float (&lg)[K], float y, const float4* consts,
                                       int use_beta) {
  float mx = lg[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = fmaxf(mx, lg[k]);
  float se = ex2((lg[0] - mx) * kLog2e);
#pragma unroll
  for (int k = 1; k < K; ++k) se += ex2((lg[k] - mx) * kLog2e);
  const float lse = mx + lg2(se) * kLn2;
  float py = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) py = (y == (float)k) ? lg[k] : py;
  const float lp = py - lse;
  if (!use_beta) return lp;
  const float4 c = *consts;
  float mass = ex2((lg[0] - lse) * c.y);
#pragma unroll
  for (int k = 1; k < K; ++k) mass += ex2((lg[k] - lse) * c.y);
  return c.z * ex2(lp * c.x) - mass;
}

// D > 0: theta_s in registers, d padded to D; D == 0: theta in shared memory.
template <int K, int D>
__global__ void __launch_bounds__(kThreads, 1)
multiclass_projection_kernel(const float* __restrict__ z,
                             const float* __restrict__ thetas,
                             const float* __restrict__ beta_p,
                             float* __restrict__ out,
                             long long N, int d, int S, int live, int rows, int xstep,
                             int use_beta) {
  extern __shared__ __align__(16) float smem[];
  const int D1 = d + 1, W = round_up(D1, 4), Kd = K * d;
  float4* consts = reinterpret_cast<float4*>(smem);   // the beta-mode constants
  float* xs = smem + 4;                         // (2, rows, W): the ring of row tiles
  float* vals = xs + 2 * rows * W;              // (2, rows, S): the tiles' values
  float* means = vals + 2 * (size_t)rows * S;   // (2, rows): their row means
  float* ths = means + 2 * rows;                // (d, K, S) when D == 0
  const int t = threadIdx.x;
  const long long n_tiles = (N + rows - 1) / rows;
  long long tile = blockIdx.x;

  if (tile < n_tiles) stage_rows(z, tile * rows, (int)min((long long)rows, N - tile * rows),
                                 D1, W, xs);
  // the pad columns [d+1, W) of every staged row: zero, never overwritten
  // (a register-path FMA multiplies them by a zero theta)
  if (W > D1) {
    for (int e = t; e < 2 * rows * (W - D1); e += kThreads) {
      const int i = e / (W - D1);
      xs[i * W + D1 + (e - i * (W - D1))] = 0.f;
    }
  }
  // thread t < live walks the pairs e = t + live i of a tile: (row,
  // sample) (r0, s0) first, then steps of (dr, ds); every thread stores
  // e = t + kThreads i, steps of (sr, ss)
  const int r0 = t / S, s0 = t - r0 * S;
  const int dr = live / S, ds = live - dr * S;
  const int sr = kThreads / S, ss = kThreads - sr * S;
  float th[K][D > 0 ? D : 1];
  if constexpr (D > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < D; ++j)
        th[k][j] = (t < live && j < d) ? thetas[(size_t)s0 * Kd + k * d + j] : 0.f;
  } else {
    for (int e = t; e < S * Kd; e += kThreads) {
      const int s = e / Kd, kj = e - s * Kd;
      const int k = kj / d, j = kj - k * d;
      ths[((size_t)j * K + k) * S + s] = thetas[e];
    }
  }
  if (t == 0) {
    const float beta = beta_p[0];
    *consts = make_float4(beta * kLog2e, (1.f + beta) * kLog2e, (beta + 1.f) / beta, 0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    const long long row0 = tile * rows;
    const int nr = (int)min((long long)rows, N - row0);
    // the next tile's copy into the other stage, read last before the
    // previous tile's first barrier
    const long long next = tile + gridDim.x;
    if (next < n_tiles)
      stage_rows(z, next * rows, (int)min((long long)rows, N - next * rows), D1, W,
                 xs + (buf ^ 1) * rows * W);
    const float* xb = xs + buf * rows * W;
    float* vb = vals + (size_t)buf * rows * S;
    float* mb = means + buf * rows;

    if (t < live) {
      if constexpr (D > 0) {
        // the thread's sample s0 stays; its rows are r0, r0 + G, ...
        // (dr = G, ds = 0), walked by pointer in steps of xstep = G W and
        // live = G S, kernel parameters, so the walk holds no stride register
        const float* xr = xb + r0 * W;
        float* vr = vb + r0 * S + s0;
        for (int n = nr > r0 ? (nr - r0 + dr - 1) / dr : 0; n > 0; --n, xr += xstep, vr += live) {
          float lg[K];
#pragma unroll
          for (int k = 0; k < K; ++k) lg[k] = 0.f;
#pragma unroll
          for (int q = 0; q < (D + 3) / 4; ++q) {
            float xq[4];   // 16-byte loads; D is even, so a last pair is 8 bytes
            if (D - 4 * q >= 4) {
              const float4 v = reinterpret_cast<const float4*>(xr)[q];
              xq[0] = v.x, xq[1] = v.y, xq[2] = v.z, xq[3] = v.w;
            } else {
              const float2 v = reinterpret_cast<const float2*>(xr)[2 * q];
              xq[0] = v.x, xq[1] = v.y, xq[2] = xq[3] = 0.f;
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (4 * q + c < D) {
#pragma unroll
                for (int k = 0; k < K; ++k) lg[k] = fmaf(xq[c], th[k][4 * q + c], lg[k]);
              }
            }
          }
          *vr = value<K>(lg, xr[d], consts, use_beta);
        }
      } else {
        for (int r = r0, s = s0; r < nr;) {
          float lg[K];
#pragma unroll
          for (int k = 0; k < K; ++k) lg[k] = 0.f;
          const float* xr = xb + r * W;
          for (int j = 0; j < d; ++j) {
            const float xj = xr[j];
            const float* tj = ths + (size_t)j * K * S + s;
#pragma unroll
            for (int k = 0; k < K; ++k) lg[k] = fmaf(xj, tj[k * S], lg[k]);
          }
          vb[r * S + s] = value<K>(lg, xr[d], consts, use_beta);
          r += dr;
          s += ds;
          if (s >= S) {
            s -= S;
            ++r;
          }
        }
      }
    }
    __syncthreads();
    // row means: thread r sums row r alone, in a fixed order (from column
    // r mod S on, wrapping, in two interleaved chains), so rows run in
    // parallel and neighbouring threads read different banks
    for (int r = t; r < nr; r += kThreads) {
      const float* vr = vb + (size_t)r * S;
      float a = 0.f, b = 0.f;
      int s = r % S;
      for (int j = 0; j + 1 < S; j += 2) {
        a += vr[s];
        s = s + 1 == S ? 0 : s + 1;
        b += vr[s];
        s = s + 1 == S ? 0 : s + 1;
      }
      if (S & 1) a += vr[s];
      mb[r] = (a + b) / (float)S;
    }
    cp_async_wait_all();   // the next tile's rows (this thread's copies)
    __syncthreads();       // the means, and every thread's copies, visible
    // the centred tile: one contiguous span of out, consecutive threads on
    // consecutive addresses
    float* o = out + row0 * S;
    const int n = nr * S;
    for (int e = t, r = r0, s = s0; e < n; e += kThreads) {
      o[e] = vb[e] - mb[r];
      r += sr;
      s += ss;
      if (s >= S) {
        s -= S;
        ++r;
      }
    }
  }
}

// The floor: the kernel's grid, block and shared memory storing the same
// (N, S) block tile by tile, with no other work.
__global__ void __launch_bounds__(kThreads, 1)
multiclass_projection_floor_kernel(float* __restrict__ out, long long N, int S, int rows) {
  const long long n_tiles = (N + rows - 1) / rows;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    const int n = (int)min((long long)rows, N - row0) * S;
    float* o = out + row0 * S;
    for (int e = threadIdx.x; e < n; e += kThreads) o[e] = 0.f;
  }
}

struct Call {
  const float *z, *thetas, *beta;
  float* out;
  long long N;
  int d, S, use_beta;
  bool floor;
  cudaStream_t stream;
};

// Raises `kernel`'s dynamic shared memory limit to `smem` once per device.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, long long& opted, long long smem) {
  if (smem <= 48 * 1024 || smem <= opted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) opted = smem;
  return err;
}

template <int K, int D>
int launch(const Call& c, const Plan& p, int dev) {
  static long long opted[kMaxDevices] = {}, opted_floor[kMaxDevices] = {};
  auto kernel = multiclass_projection_kernel<K, D>;
  cudaError_t err;
  if ((err = opt_in(kernel, opted[dev], p.smem)) != cudaSuccess) return (int)err;
  int n_sm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           (size_t)p.smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // a persistent grid: at most one wave of resident blocks
  const long long n_tiles = (c.N + p.rows - 1) / p.rows;
  const long long cap = (long long)n_sm * per_sm;
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);
  if (c.floor) {
    if ((err = opt_in(multiclass_projection_floor_kernel, opted_floor[dev], p.smem)) != cudaSuccess)
      return (int)err;
    multiclass_projection_floor_kernel<<<grid, kThreads, p.smem, c.stream>>>(c.out, c.N, c.S,
                                                                             p.rows);
  } else {
    // the register path's row step in x: G = live / S rows of W floats
    const int xstep = p.live / c.S * round_up(c.d + 1, 4);
    kernel<<<grid, kThreads, p.smem, c.stream>>>(c.z, c.thetas, c.beta, c.out, c.N, c.d, c.S,
                                                 p.live, p.rows, xstep, c.use_beta);
  }
  return (int)cudaGetLastError();
}

// The register path's instantiations: D = 2, 4, ..., kMaxRegD with
// K (D + 3) <= kRegBudget.
template <int K, int D = 2>
int launch_reg(const Call& c, const Plan& p, int dev) {
  if constexpr (D > kMaxRegD || K * (D + 3) > kRegBudget) {
    return (int)cudaErrorInvalidValue;
  } else {
    return p.D == D ? launch<K, D>(c, p, dev) : launch_reg<K, D + 2>(c, p, dev);
  }
}

template <int K>
int launch_k(const Call& c, const Plan& p, int dev) {
  return p.D == 0 ? launch<K, 0>(c, p, dev) : launch_reg<K>(c, p, dev);
}

int run(const Call& c, int K) {
  if (c.N < 1 || c.d < 1 || c.d > kMaxD || c.S < 1 || K < 2 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  const Plan p = make_plan(c.d, K, c.S, limit);
  if (p.smem > limit) return (int)cudaErrorInvalidValue;
  switch (K) {
#define BC_CASE(k) \
  case k:          \
    return launch_k<k>(c, p, dev);
    BC_CASE(2) BC_CASE(3) BC_CASE(4) BC_CASE(5) BC_CASE(6) BC_CASE(7)
    BC_CASE(8) BC_CASE(9) BC_CASE(10) BC_CASE(11) BC_CASE(12) BC_CASE(13)
    BC_CASE(14) BC_CASE(15) BC_CASE(16)
#undef BC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The plan of one launch with `smem_limit` bytes of shared memory a
// block: out = [D (0: theta in shared memory), live threads, rows per
// tile, dynamic shared memory in bytes].
void multiclass_projection_plan(int d, int K, int S, long long smem_limit, long long* out) {
  const Plan p = make_plan(d, K, S, smem_limit);
  out[0] = p.D;
  out[1] = p.live;
  out[2] = p.rows;
  out[3] = p.smem;
}

// Launches one projection on `stream`; returns the cudaError_t of the
// launch (0 on success). Allocates nothing and does not synchronise.
// Needs 1 <= N, 1 <= d <= 32, 2 <= K <= 16, 1 <= S, and the plan's shared
// memory within the card's limit.
int multiclass_projection(const void* z, const void* thetas, const void* beta, void* out,
                          long long N, int d, int K, int S, int use_beta, void* stream) {
  return run({(const float*)z, (const float*)thetas, (const float*)beta, (float*)out, N, d, S,
              use_beta, false, (cudaStream_t)stream},
             K);
}

// The floor of one projection at these shapes: the same grid, block and
// shared memory storing zeros over out (N, S), tile by tile.
int multiclass_projection_floor(void* out, long long N, int d, int K, int S, void* stream) {
  return run({nullptr, nullptr, nullptr, (float*)out, N, d, S, 0, true, (cudaStream_t)stream}, K);
}

}  // extern "C"
