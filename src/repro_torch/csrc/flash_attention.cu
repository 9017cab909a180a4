// GQA flash-attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/attention/kernel.py.  It computes what that kernel
// computes, not its block structure:
//
//   * one thread block per (q tile, q head, batch); a loop over the kv tiles
//     inside the block takes the place of the Pallas grid's sequential kv
//     axis, and the running max m, sum l and accumulator acc that the TPU
//     kernel keeps in VMEM scratch live in registers;
//   * the kv head of q head h is h / (hq / hkv), so any group size works
//     (Qwen2.5-14B's is 5);
//   * all arithmetic is f32 (scalar FMA, no tensor cores, no TF32), on inputs
//     read as f32 or bf16; the output is written in the input type;
//   * the causal mask is the TPU kernel's: masked logits are -1e30, m starts
//     at -1e30, p is set to 0 where masked, and the denominator is
//     max(l, 1e-30).  Kv tiles entirely above the diagonal are skipped: there
//     every p is 0 and the rescale factor is exp(0) = 1, so skipping them
//     changes no bit of the result (the first tile of every row holds key 0
//     and is never fully masked).
//
// Bound on the H100: operations.  The causal forward at S = 4096, D = 128
// does 4 * D flops per (query, key) pair against 2 bytes per element read
// once; at 989 TFLOP/s (bf16 tensor cores) the operation bound is six times
// the byte bound.  This first kernel does not reach the tensor cores: it
// runs the products as f32 FMAs out of shared memory, bounded by the FMA
// pipe (67 TFLOP/s) and by shared-memory load bandwidth.  What the design
// does about that: each thread holds a 4-row register tile of scores and of
// the accumulator, so every value loaded from shared memory feeds 4 to 8
// FMAs; K is stored transposed and Q, K and P with a padded row, so the
// loads of a warp fall in distinct banks; skipping the masked tiles halves
// the work of the causal case.  Tensor cores (with P rounded to bf16, a
// departure from the TPU kernel's f32 p) are later work.
//
// Shared memory per block, in f32: Q (BQ x (D+1)), K^T (D x (BKV+1)),
// V (BKV x D), P (BQ x (BKV+1)); 116 KB at BQ = BKV = 64, D = 128 and at
// most 165,376 B (BQ = 128, BKV = 64), so it is dynamic shared memory, allowed
// per instantiation with cudaFuncSetAttribute.  This layout is stated here
// only: flash_attention_attributes reports it, and a tile that would exceed
// the 227 KB a block can have does not compile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 4;           // query rows per thread
constexpr int kColThreads = 16;    // threads across the kv / head-dim axis
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int BQ, int BKV, int D>
struct Tile {
  static constexpr int kThreads = BQ / kRows * kColThreads;
  static constexpr int kQ = BQ * (D + 1);
  static constexpr int kKt = D * (BKV + 1);
  static constexpr int kV = BKV * D;
  static constexpr int kP = BQ * (BKV + 1);
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * (kQ + kKt + kV + kP);
  static_assert(kBytes <= kMaxSmemBytes, "tile exceeds the shared memory of an H100 block");
};

// Sum or max over the 16 lanes of one row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kColThreads / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kColThreads / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int BQ, int BKV, int D>
__global__ void __launch_bounds__(Tile<BQ, BKV, D>::kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
                           int seq, int causal, float scale) {
  using TL = Tile<BQ, BKV, D>;
  constexpr int CS = BKV / kColThreads;  // score columns per thread
  constexpr int CD = D / kColThreads;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;          // [BQ][D + 1]
  float* kt = qs + TL::kQ;   // [D][BKV + 1], K transposed
  float* vs = kt + TL::kKt;  // [BKV][D]
  float* ps = vs + TL::kV;   // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int row0 = (tid / kColThreads) * kRows;  // first of this thread's query rows
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int kv_head = head / (hq / hkv);
  const int64_t q_off = ((static_cast<int64_t>(batch) * hq + head) * seq + q0) * D;
  const int64_t kv_off = (static_cast<int64_t>(batch) * hkv + kv_head) * seq * D;

  for (int i = tid; i < BQ * D; i += TL::kThreads)
    qs[(i / D) * (D + 1) + i % D] = to_f32(q[q_off + i]);

  float m[kRows], l[kRows], acc[kRows][CD];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CD; ++e) acc[a][e] = 0.f;
  }

  const int n_kv = causal ? min(seq / BKV, (q0 + BQ + BKV - 1) / BKV) : seq / BKV;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    const int64_t tile_off = kv_off + static_cast<int64_t>(k0) * D;
    for (int i = tid; i < BKV * D; i += TL::kThreads) {
      kt[(i % D) * (BKV + 1) + i / D] = to_f32(k[tile_off + i]);
      vs[i] = to_f32(v[tile_off + i]);
    }
    __syncthreads();

    // s = (q . k) * scale for this thread's rows row0 + a and keys tx + 16 c
    float s[kRows][CS];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < CS; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[CS];
#pragma unroll
      for (int a = 0; a < kRows; ++a) qv[a] = qs[(row0 + a) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < CS; ++c) kv[c] = kt[d * (BKV + 1) + tx + kColThreads * c];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < CS; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    // online softmax update, row by row
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int q_pos = q0 + row0 + a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        float x = s[a][c] * scale;
        if (causal && q_pos < k0 + tx + kColThreads * c) x = kNegInf;
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        const int col = tx + kColThreads * c;
        float p = expf(s[a][c] - m_new);
        if (causal && q_pos < k0 + col) p = 0.f;
        ps[(row0 + a) * (BKV + 1) + col] = p;
        sum += p;
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < CD; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();

    // acc += p v for this thread's rows and head-dim columns tx + 16 e
#pragma unroll 4
    for (int jj = 0; jj < BKV; ++jj) {
      float pv[kRows], vv[CD];
#pragma unroll
      for (int a = 0; a < kRows; ++a) pv[a] = ps[(row0 + a) * (BKV + 1) + jj];
#pragma unroll
      for (int e = 0; e < CD; ++e) vv[e] = vs[jj * D + tx + kColThreads * e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int e = 0; e < CD; ++e) acc[a][e] = fmaf(pv[a], vv[e], acc[a][e]);
    }
  }

  const int64_t o_off = q_off + static_cast<int64_t>(row0) * D;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const float denom = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int e = 0; e < CD; ++e)
      store(out + o_off + a * D + tx + kColThreads * e, acc[a][e] / denom);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int batch, hq, hkv, seq, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int BQ, int BKV, int D>
int launch_tile(const Args& a) {
  using TL = Tile<BQ, BKV, D>;
  auto kernel = flash_attention_kernel<T, BQ, BKV, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // do not leave the error for the next launch's check
    return static_cast<int>(err);
  }
  const dim3 grid(a.seq / BQ, a.hq, a.batch);
  kernel<<<grid, TL::kThreads, TL::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.hq, a.hkv, a.seq, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

struct Attrs {
  cudaFuncAttributes func;
  int smem_bytes;
};

template <typename T, int BQ, int BKV, int D>
int attrs_tile(Attrs* out) {
  out->smem_bytes = Tile<BQ, BKV, D>::kBytes;
  return static_cast<int>(cudaFuncGetAttributes(&out->func, flash_attention_kernel<T, BQ, BKV, D>));
}

// Calls F<T, BQ, BKV, D>(arg) for the compiled (block_q, block_kv) tiles:
// (64, 64), picked wherever 64 divides S; (32, 32) for the other multiples
// of 32; (128, 64) and (64, 32), the runners-up at Qwen2.5-14B's shape,
// kept so that every timing run shows the margin of the pick.
#define FLASH_TILES(F, T, D, BQ_, BKV_, ARG)            \
  switch ((BQ_) * 1000 + (BKV_)) {                      \
    case 32032: return F<T, 32, 32, D>(ARG);            \
    case 64032: return F<T, 64, 32, D>(ARG);            \
    case 64064: return F<T, 64, 64, D>(ARG);            \
    case 128064: return F<T, 128, 64, D>(ARG);          \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T, int D>
int launch_d(int bq, int bkv, const Args& a) {
  FLASH_TILES(launch_tile, T, D, bq, bkv, a)
}

template <typename T, int D>
int attrs_d(int bq, int bkv, Attrs* out) {
  FLASH_TILES(attrs_tile, T, D, bq, bkv, out)
}

template <typename T>
int launch_typed(int d, int bq, int bkv, const Args& a) {
  switch (d) {
    case 32: return launch_d<T, 32>(bq, bkv, a);
    case 64: return launch_d<T, 64>(bq, bkv, a);
    case 128: return launch_d<T, 128>(bq, bkv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int attrs_typed(int d, int bq, int bkv, Attrs* out) {
  switch (d) {
    case 32: return attrs_d<T, 32>(bq, bkv, out);
    case 64: return attrs_d<T, 64>(bq, bkv, out);
    case 128: return attrs_d<T, 128>(bq, bkv, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  q, out: (batch, hq, seq, d); k, v: (batch, hkv,
// seq, d), all contiguous.  Returns cudaGetLastError() after the launch (0
// on success); argument errors return cudaErrorInvalidValue.
int flash_attention_launch(int dtype, int d, int block_q, int block_kv, const void* q,
                           const void* k, const void* v, void* out, int batch, int hq,
                           int hkv, int seq, int causal, float scale, void* stream) {
  if (batch < 1 || hkv < 1 || hq % hkv || seq % block_q || seq % block_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, batch, hq, hkv, seq, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_typed<float>(d, block_q, block_kv, a);
    case 1: return launch_typed<__nv_bfloat16>(d, block_q, block_kv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers and local (spill) bytes per thread, the largest block, and the
// dynamic shared memory of the compiled instantiation.
int flash_attention_attributes(int dtype, int d, int block_q, int block_kv, int* regs,
                               int* local_bytes, int* max_threads, int* smem_bytes) {
  Attrs a;
  int err;
  switch (dtype) {
    case 0: err = attrs_typed<float>(d, block_q, block_kv, &a); break;
    case 1: err = attrs_typed<__nv_bfloat16>(d, block_q, block_kv, &a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  *regs = a.func.numRegs;
  *local_bytes = static_cast<int>(a.func.localSizeBytes);
  *max_threads = a.func.maxThreadsPerBlock;
  *smem_bytes = a.smem_bytes;
  return 0;
}

}  // extern "C"
