// Row-wise LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its norms
// (src/repro/models/layers.py, `layernorm` and `rmsnorm`) to XLA, which fuses
// each into one pass.  The port's eager formula (kernels/norm/ref.py,
// `norm_plain`) runs about nine full-size passes forward and twice as many in
// autograd's backward; these kernels run one pass each way.
//
// Arithmetic: the eager formula's, with the same rounding points.  The row's
// statistics are f32: the mean, then the mean of squared deviations from it,
// both from the values held in registers (LayerNorm), or the mean of squares
// (RMSNorm, whose mean is 0); rstd = rsqrt(var + eps); y = (x - mean) * rstd,
// times the weight, plus the bias, each an f32 operation of its own (no FMA
// contraction), rounded once to x's type.  Each mean is the sum times 1 / d,
// as PyTorch's mean reduction takes it.  The backward reads x, dy and the
// row's saved mean and rstd and recomputes xhat = (x - mean) * rstd:
//
//   g  = dy * w                                        (dy without a weight)
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))  (LayerNorm)
//   dx = rstd * (g - xhat * mean(g * xhat))            (RMSNorm)
//   dw = sum over rows of dy * xhat,   db = sum over rows of dy
//
// dw and db: each block of the backward walks rows b, b + grid, ... and sums
// its columns' terms in registers, then writes one f32 row of partials; a
// second kernel sums the partials over the blocks in a fixed order.  So a
// launch gives the same bits every time.
//
// Bound on the H100: device-memory bytes (a few flops a byte).  Forward: x
// read and y written, 4 B a (row, channel) in bf16, 8 in f32, plus 8 B a row
// of statistics where they are kept; backward: x and dy read, dx written,
// 6 B a (row, channel) in bf16, 12 in f32, plus the partials (grid x d f32 for
// dw and again for db, about 1 % of the traffic at the models' shapes).
//
// Design: a row lives in registers between its loads and its stores, so x is
// read once.  The threads of a row, whole warps (the forward holds 64 values
// a thread: one warp a row up to d = 2048, up to four to d = 8192; the
// backward 16, since it holds x, dy, the weight and the sums of dw and db),
// load 16 B each, neighbouring threads on neighbouring addresses, and sum by
// a butterfly of warp shuffles (every lane ends with the same bits) and,
// across the row's warps, through shared memory in warp order.  A width that
// is not a multiple of 16 B, or a pointer off a 16-B boundary, takes the same
// kernels with one element a load (the wrapper chooses; kernels/norm/kernel.py
// computes the geometry).  Threads past the row's end load zeros and store
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;  // of a row: d <= 8192 with 16 values a thread in the backward
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kSumRows = 8;  // warps of the partials' sum, each over every 8th block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) { *out = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// 16 bytes at p (16-B aligned) as f32 values
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  q.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  q.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  q.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  q.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = q;
}

// V consecutive elements at p: one 16-B access where V fills 16 B, else one
// element (V = 1)
template <typename T, int V>
__device__ __forceinline__ void load_values(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    load16(p, v);
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_values(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    from_f32(v[0], p);
  } else {
    store16(p, v);
  }
}
// V consecutive f32 values (the weight, the bias): 16-B accesses where V is a
// multiple of 4 (the wrapper checks their alignment with x's)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// The sums of s[k] over the threads of one row (threadIdx.y's: blockDim.x of
// them, whole warps), the same bits in every thread: a butterfly in each
// warp (a + b == b + a, so every lane ends equal), then the warps' sums in
// warp order.  Every thread of the block calls it the same number of times.
template <int K>
__device__ __forceinline__ void row_sum(float (&s)[K], float* red) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
  }
  const int warps = blockDim.x >> 5;
  if (warps == 1) return;
  float* r = red + threadIdx.y * warps * K;
  __syncthreads();  // the previous call's reads are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[(threadIdx.x >> 5) * K + k] = s[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
    for (int i = 0; i < warps; ++i) t += r[i * K + k];
    s[k] = t;
  }
}

// One row a threadIdx.y, blockDim.x threads a row; each thread holds P
// values in N = P / V vectors, vector j at column (j blockDim.x + x) V.
// stats (2, rows): the mean (0 for RMSNorm) and rstd, written where not null.
template <typename T, int V, int P>
__global__ void __launch_bounds__(kFwdThreads) norm_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b, T* __restrict__ y,
    float* __restrict__ stats, int rows, int d, float inv_d, float eps, int rms) {
  constexpr int N = P / V;
  __shared__ float red[kFwdThreads / 32];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * d;
  float v[N][V];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (j * blockDim.x + threadIdx.x) * V;
    if (live && c < d) {
      load_values<T, V>(x + base + c, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) v[j][k] = 0.f;
    }
  }
  float s[1] = {0.f};
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) s[0] += v[j][k];
  }
  row_sum(s, red);
  const float mu = rms ? 0.f : __fmul_rn(s[0], inv_d);
  float q[1] = {0.f};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (j * blockDim.x + threadIdx.x) * V;
    if (c < d) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float t = __fsub_rn(v[j][k], mu);
        q[0] = __fadd_rn(q[0], __fmul_rn(t, t));
      }
    }
  }
  row_sum(q, red);
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(q[0], inv_d), eps));
  if (!live) return;  // no barrier after this
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (j * blockDim.x + threadIdx.x) * V;
    if (c >= d) continue;
    float o[V], wv[V], bv[V];
    if (w != nullptr) load_f32<V>(w + c, wv);
    if (b != nullptr) load_f32<V>(b + c, bv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = __fmul_rn(__fsub_rn(v[j][k], mu), rstd);
      if (w != nullptr) t = __fmul_rn(t, wv[k]);
      if (b != nullptr) t = __fadd_rn(t, bv[k]);
      o[k] = t;
    }
    store_values<T, V>(y + base + c, o);
  }
  if (stats != nullptr && threadIdx.x == 0) {
    stats[row] = mu;
    stats[rows + row] = rstd;
  }
}

// One row at a time a block (blockDim.x threads, blockDim.y = 1), rows
// blockIdx.x, + gridDim.x, ...; each thread P values as in the forward.
// AFF: 0 no weight, 1 a weight (dw), 2 a weight and a bias (dw, db).
// part (AFF, gridDim.x, d): each block's sums of dw's and db's terms.
template <typename T, int V, int P, int AFF>
__global__ void __launch_bounds__(kBwdThreads) norm_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ stats,
    const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ part, int rows, int d, float inv_d,
    int rms) {
  constexpr int N = P / V;
  constexpr int NW = AFF >= 1 ? N : 1;
  constexpr int NB = AFF == 2 ? N : 1;
  __shared__ float red[2 * kMaxWarps];
  float wv[NW][V], aw[NW][V], ab[NB][V];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (j * blockDim.x + threadIdx.x) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (AFF >= 1) { wv[j][k] = 0.f; aw[j][k] = 0.f; }
      if constexpr (AFF == 2) ab[j][k] = 0.f;
    }
    if constexpr (AFF >= 1) {
      if (c < d) load_f32<V>(w + c, wv[j]);
    }
  }
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {  // the same trips for every thread
    const size_t base = static_cast<size_t>(row) * d;
    const float mu = stats[row], rs = stats[rows + row];
    float xh[N][V], dv[N][V];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c < d) {
        load_values<T, V>(x + base + c, xh[j]);
        load_values<T, V>(dy + base + c, dv[j]);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xh[j][k] = __fmul_rn(__fsub_rn(xh[j][k], mu), rs);
          float g = dv[j][k];
          if constexpr (AFF >= 1) g = __fmul_rn(g, wv[j][k]);
          s[0] = __fadd_rn(s[0], g);
          s[1] = __fadd_rn(s[1], __fmul_rn(g, xh[j][k]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) { xh[j][k] = 0.f; dv[j][k] = 0.f; }
      }
    }
    row_sum(s, red);
    const float c1 = rms ? 0.f : __fmul_rn(s[0], inv_d), c2 = __fmul_rn(s[1], inv_d);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c >= d) continue;
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float g = dv[j][k];
        if constexpr (AFF >= 1) g = __fmul_rn(g, wv[j][k]);
        o[k] = __fmul_rn(rs, __fsub_rn(__fsub_rn(g, c1), __fmul_rn(xh[j][k], c2)));
        if constexpr (AFF >= 1) aw[j][k] = __fadd_rn(aw[j][k], __fmul_rn(dv[j][k], xh[j][k]));
        if constexpr (AFF == 2) ab[j][k] = __fadd_rn(ab[j][k], dv[j][k]);
      }
      store_values<T, V>(dx + base + c, o);
    }
  }
  if constexpr (AFF >= 1) {
    float* pw = part + static_cast<size_t>(blockIdx.x) * d;
    float* pb = part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * d;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = (j * blockDim.x + threadIdx.x) * V;
      if (c >= d) continue;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        pw[c + k] = aw[j][k];
        if constexpr (AFF == 2) pb[c + k] = ab[j][k];
      }
    }
  }
}

// out[c] = the sum over g < grid of part[g][c]: warp y sums blocks y, y + 8,
// ... in order, then the eight sums in order.
__global__ void __launch_bounds__(32 * kSumRows) norm_sum_kernel(const float* __restrict__ part, int grid, int d,
                                                                 float* __restrict__ out) {
  __shared__ float s[kSumRows][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (c < d) {
    for (int g = threadIdx.y; g < grid; g += kSumRows) t += part[static_cast<size_t>(g) * d + c];
  }
  s[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < kSumRows; ++i) u += s[i][threadIdx.x];
    out[c] = u;
  }
}

// The compiled instantiations: (dtype, vector or one element a load), the
// forward at 64 values a thread and the backward at 16.
constexpr int kFwdValues = 64;
constexpr int kBwdValues = 16;

template <typename T, int V, int P>
const void* fwd_fn() { return reinterpret_cast<const void*>(&norm_fwd_kernel<T, V, P>); }

template <typename T, int V, int P>
const void* bwd_fn(int aff) {
  switch (aff) {
    case 0: return reinterpret_cast<const void*>(&norm_bwd_kernel<T, V, P, 0>);
    case 1: return reinterpret_cast<const void*>(&norm_bwd_kernel<T, V, P, 1>);
    case 2: return reinterpret_cast<const void*>(&norm_bwd_kernel<T, V, P, 2>);
    default: return nullptr;
  }
}

template <typename T>
const void* fwd_kernel(int vector, int values) {
  constexpr int V = 16 / sizeof(T);
  if (values != kFwdValues) return nullptr;
  return vector ? fwd_fn<T, V, kFwdValues>() : fwd_fn<T, 1, kFwdValues>();
}

template <typename T>
const void* bwd_kernel(int vector, int values, int aff) {
  constexpr int V = 16 / sizeof(T);
  if (values != kBwdValues) return nullptr;
  return vector ? bwd_fn<T, V, kBwdValues>(aff) : bwd_fn<T, 1, kBwdValues>(aff);
}

// dtype 0: f32, 1: bf16
const void* kernel_of(int backward, int dtype, int vector, int values, int aff) {
  if (dtype == 0) return backward ? bwd_kernel<float>(vector, values, aff) : fwd_kernel<float>(vector, values);
  if (dtype == 1)
    return backward ? bwd_kernel<__nv_bfloat16>(vector, values, aff) : fwd_kernel<__nv_bfloat16>(vector, values);
  return nullptr;
}

int vec_of(int dtype, int vector) { return vector ? (dtype == 0 ? 4 : 8) : 1; }

}  // namespace

extern "C" {

// x, y: (rows, d) f32 (dtype 0) or bf16 (dtype 1), contiguous; w, b: (d,) f32
// or null; stats: (2, rows) f32 (the mean, then rstd) or null.  `warps` warps
// a row, `rows_per_block` rows a block, `values` values a thread, `vector`:
// 16-B accesses (d a multiple of 16 B, every pointer 16-B aligned).  Launches
// the forward on `stream`; returns cudaGetLastError() after it (0 on
// success), cudaErrorInvalidValue for a geometry that is not compiled or does
// not cover the row.
int norm_fwd_launch(int dtype, int vector, int warps, int rows_per_block, int values, const void* x,
                    const float* w, const float* b, void* y, float* stats, int rows, int d, float eps, int rms,
                    void* stream) {
  const void* fn = kernel_of(0, dtype, vector, values, 0);
  if (fn == nullptr || rows < 1 || d < 1 || warps < 1 || rows_per_block < 1 ||
      32 * warps * rows_per_block > kFwdThreads || 32 * warps * values < d || d % vec_of(dtype, vector))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * warps, rows_per_block);
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block);
  float inv_d = 1.0f / static_cast<float>(d);
  void* args[] = {&x, &w, &b, &y, &stats, &rows, &d, &inv_d, &eps, &rms};
  cudaLaunchKernel(fn, grid, block, args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: (rows, d) of one dtype; stats: the forward's (2, rows); w: (d,)
// f32 or null (no weight: dw and db not computed); dw: (d,) f32 where w is
// given; db: (d,) f32 or null (no bias); part: (2 if db else 1, grid, d) f32
// scratch where w is given.  `grid` blocks walk the rows; then the partials'
// sums into dw and db.  Returns as norm_fwd_launch.
int norm_bwd_launch(int dtype, int vector, int warps, int values, int grid, const void* x, const void* dy,
                    const float* stats, const float* w, void* dx, float* dw, float* db, float* part, int rows,
                    int d, int rms, void* stream) {
  const int aff = w == nullptr ? 0 : (db == nullptr ? 1 : 2);
  const void* fn = kernel_of(1, dtype, vector, values, aff);
  if (fn == nullptr || rows < 1 || d < 1 || grid < 1 || warps < 1 || warps > kMaxWarps ||
      32 * warps * values < d || d % vec_of(dtype, vector) || stats == nullptr ||
      (aff > 0 && (dw == nullptr || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float inv_d = 1.0f / static_cast<float>(d);
  void* args[] = {&x, &dy, &stats, &w, &dx, &part, &rows, &d, &inv_d, &rms};
  cudaLaunchKernel(fn, dim3(grid), dim3(32 * warps), args, 0, s);
  if (aff > 0) {
    const dim3 sum_grid((d + 31) / 32), sum_block(32, kSumRows);
    norm_sum_kernel<<<sum_grid, sum_block, 0, s>>>(part, grid, d, dw);
    if (aff == 2) norm_sum_kernel<<<sum_grid, sum_block, 0, s>>>(part + static_cast<size_t>(grid) * d, grid, d, db);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spill) bytes per thread, the largest block and the
// static shared memory of the forward (backward = 0) or backward (1) at
// (dtype, vector, values, aff), as norm_fwd_launch and norm_bwd_launch take them.
int norm_attributes(int backward, int dtype, int vector, int values, int aff, int* regs, int* local_bytes,
                    int* max_threads, int* smem_bytes) {
  const void* fn = kernel_of(backward, dtype, vector, values, aff);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

}  // extern "C"
