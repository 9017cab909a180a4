// GQA flash-attention forward with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/attention/kernel.py.  It computes what that kernel
// computes, not its block structure:
//
//   * one thread block per (q head, batch, q tile); a loop over the kv tiles
//     inside the block takes the place of the Pallas grid's sequential kv
//     axis, and the running max m, sum l and accumulator acc that the TPU
//     kernel keeps in VMEM scratch live in registers;
//   * the kv head of q head h is h / (hq / hkv), so any group size works
//     (Qwen2.5-14B's is 5);
//   * the causal mask is the TPU kernel's: masked logits are -1e30, m starts
//     at -1e30, p is set to 0 where masked, and the denominator is
//     max(l, 1e-30).  Kv tiles entirely above the diagonal are skipped: there
//     every p is 0 and the rescale factor is exp(0) = 1, so skipping them
//     changes no bit of the result (the first tile of every row holds key 0
//     and is never fully masked).  The same holds for a warp whose 16 rows
//     all lie above a kv tile: it skips that tile's products.
//
// Bound on the H100: operations.  The causal forward at S = 4096, D = 128
// does 4 * D flops per (query, key) pair against 2 bytes per element read
// once; at 989 TFLOP/s (bf16 tensor cores) the operation bound is six times
// the byte bound.  What the design does about that, by input type:
//
// bf16 (the models' type) runs both products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//   * each warp owns 16 query rows; a block of BQ rows has BQ / 16 warps.
//     Q's A fragments are loaded with ldmatrix once per block and stay in
//     registers;
//   * K and V tiles stay bf16 in shared memory in their own row-major layout,
//     each row padded by 16 bytes so that the 8 rows an ldmatrix reads fall
//     in distinct banks.  K's rows are S = Q K^T's B fragments as they are
//     (ldmatrix); V's come transposed (ldmatrix.trans);
//   * K and V are copied with cp.async into two stages, so the loads of kv
//     tile j + 1 run under the products of tile j;
//   * the online softmax runs on the accumulator fragments: a thread holds
//     two rows (g and g + 8 of its warp's 16) and a row's max and sum are
//     taken over the 4 lanes of a quad;
//   * P stays in registers: the m16n8 C fragment of S has the layout of the
//     m16n8k16 A fragment of P V.  The TPU kernel keeps p in f32, and P
//     rounded once to bf16 fails the bf16 attention rule at S = 4096 (the
//     port's PERF.md).  So P is split, P_hi = bf16(p), P_lo = bf16(p - P_hi),
//     and P V = P_hi V + P_lo V: 1.5 times the tensor-core work of bf16 P,
//     with p kept to about 2^-17 of its value.  l is summed from the f32 p;
//   * causal q tiles run longest first (the q tile is the grid's slowest
//     axis, reversed), so the short tiles of the causal tail fill the last
//     wave.
// f32 keeps the scalar kernel: TF32 on the tensor cores would miss the f32
// limit of 3e-5 that this path meets (8.94e-7, the port's PERF.md), and the
// models' path is bf16.  Each thread holds a 4-row register tile of scores
// and of the accumulator, so every value loaded from shared memory feeds 4
// to 8 FMAs; K is stored transposed and Q, K and P with a padded row.
//
// Head dims.  The kernels take any D that is a multiple of 16 (whole mma
// fragments; the P V loop steps O's n tiles in pairs, so D / 8 is even);
// the dispatch compiles 16 (the models' smoke configs), 32, 64, 112
// (Zamba2-7B), 128 (Qwen2.5-14B) and 160 (StableLM-12B) on every tile.
//
// What training adds.  Given an `lse` pointer (the autograd Function of
// kernels/attention/kernel.py), each row's m + log(max(l, 1e-30)) is
// written in f32, so that the backward (flash_attention_bwd.cu) recomputes
// P = exp(x - lse) without a second pass over the keys.  Given `out_lo`
// (bf16), the output's rounding error bf16(o - bf16(o)) is written beside
// it, split as P is: the backward's D = rowsum(dO o o) from the rounded
// output alone misses the plain version's gradient by 20 to 35 times
// ATTN_GRAD_RULE where a causal row sees few keys (chip_smoke.py's
// `without_out_lo`).
// The serving path passes null for both and writes nothing more.
//
// Shared memory per block.  bf16: Q (BQ x (D+8)), then K and V (BKV x (D+8)
// each) in two stages, in bf16: 87 KB at (64, 64), D = 128, so two blocks
// share an SM; at most 129,024 B, at (128, 64), D = 160.  f32: Q
// (BQ x (D+1)), K^T (D x (BKV+1)), V (BKV x D), P (BQ x (BKV+1)), in f32: at
// most 198,272 B, at (128, 64), D = 160.  Both are dynamic shared
// memory, allowed per instantiation with cudaFuncSetAttribute.  This layout
// is stated here only: flash_attention_attributes reports it, and a tile
// that would exceed the 227 KB a block can have does not compile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmemBytes = 232448;
constexpr int kSmRegisters = 65536;

// ---- PTX: shared-memory address, cp.async, ldmatrix, mma.sync ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register m receives row lane / 4, columns 2 (lane % 4) and
// 2 (lane % 4) + 1 of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each matrix transposed: register m receives rows 2 (lane % 4)
// and 2 (lane % 4) + 1 of column lane / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column-major fragment) and a 16x8 f32 d
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 p of neighbouring columns as (P_hi, P_lo) pairs of bf16
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

// max or sum over the 4 lanes of a quad, which hold one row of a fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- bf16: tensor cores -----------------------------------------------

template <int BQ, int BKV, int D>
struct TcTile {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRow = D + 8;  // bf16 per padded row
  static constexpr int kQ = BQ * kRow;
  static constexpr int kKV = BKV * kRow;  // one K or V tile
  static constexpr int kBytes = static_cast<int>(sizeof(bf16)) * (kQ + 4 * kKV);
  // registers a thread needs, roughly: O (D / 2), Q fragments (D / 4),
  // S (BKV / 2) and 64 for the rest; two blocks per SM where that allows
  static constexpr int kRegs = D / 2 + D / 4 + BKV / 2 + 64;
  static constexpr int kMinBlocks = kSmRegisters / (kThreads * kRegs) >= 2 ? 2 : 1;
  static_assert(BQ % 16 == 0 && BKV % 16 == 0 && D % 16 == 0, "tiles are whole mma fragments");
  static_assert(kBytes <= kMaxSmemBytes, "tile exceeds the shared memory of an H100 block");
};

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__((TcTile<BQ, BKV, D>::kThreads), (TcTile<BQ, BKV, D>::kMinBlocks))
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                    bf16* __restrict__ out_lo, int hq, int hkv, int seq, int causal, float scale) {
  using TL = TcTile<BQ, BKV, D>;
  constexpr int R = TL::kRow;
  constexpr int KD = D / 16;   // k steps of Q K^T
  constexpr int NS = BKV / 8;  // n tiles of S
  constexpr int ND = D / 8;    // n tiles of O
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [BQ][D + 8]
  bf16* kvs = qs + TL::kQ;  // stage st: K at kvs + 2 st kKV, V after it

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row group, lane in quad
  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q_tile = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int q0 = q_tile * BQ;
  const int wrow = warp * 16;  // this warp's first row in the tile
  const int kv_head = head / (hq / hkv);
  const int64_t q_off = ((static_cast<int64_t>(batch) * hq + head) * seq + q0) * D;
  const int64_t kv_off = (static_cast<int64_t>(batch) * hkv + kv_head) * seq * D;

  auto load_rows = [&](bf16* dst, const bf16* src, int rows) {
    for (int i = tid; i < rows * kPieces; i += TL::kThreads) {
      const int r = i / kPieces, c = (i % kPieces) * 8;
      cp_async16(dst + r * R + c, src + static_cast<int64_t>(r) * D + c);
    }
  };
  auto load_kv = [&](int j) {
    bf16* st = kvs + (j & 1) * 2 * TL::kKV;
    const int64_t off = kv_off + static_cast<int64_t>(j) * BKV * D;
    load_rows(st, k + off, BKV);
    load_rows(st + TL::kKV, v + off, BKV);
  };

  const int n_kv = causal ? min(seq / BKV, (q0 + BQ + BKV - 1) / BKV) : seq / BKV;
  load_rows(qs, q + q_off, BQ);
  cp_async_commit();
  load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldmatrix_x4(qf[kd], qs + (wrow + lane % 8 + (lane / 8) % 2 * 8) * R + kd * 16 + lane / 16 * 8);

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + wrow + g, q0 + wrow + g + 8};  // this thread's two rows

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* ks = kvs + (j & 1) * 2 * TL::kKV;
    const bf16* vs = ks + TL::kKV;
    const int k0 = j * BKV;
    if (!causal || k0 <= q0 + wrow + 15) {  // else every row of this warp is masked here
      float s[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int nt = 0; nt < NS; nt += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (nt * 8 + lane % 8 + lane / 16 * 8) * R + kd * 16 + (lane / 8) % 2 * 8);
          mma_bf16_16816(s[nt], qf[kd], b[0], b[1]);
          mma_bf16_16816(s[nt + 1], qf[kd], b[2], b[3]);
        }
      }

      // online softmax on the fragments: element e of s[nt] is row row[e / 2],
      // key k0 + 8 nt + 2 tq + e % 2
      const bool diag = causal && k0 + BKV - 1 > q0 + wrow;  // some key of the tile is masked
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale;
          if (diag && row[e / 2] < k0 + nt * 8 + 2 * tq + e % 2) x = kNegInf;
          s[nt][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) m_new[h] = fmaxf(m[h], quad_max(mx[h]));
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(s[nt][e] - m_new[e / 2]);
          if (diag && row[e / 2] < k0 + nt * 8 + 2 * tq + e % 2) p = 0.f;
          s[nt][e] = p;
          sum[e / 2] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float alpha = expf(m[h] - m_new[h]);
        l[h] = l[h] * alpha + quad_sum(sum[h]);
        m[h] = m_new[h];
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[nd][2 * h] *= alpha;
          acc[nd][2 * h + 1] *= alpha;
        }
      }

      // acc += P_hi V + P_lo V, 16 keys at a time
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * R + nd * 8 + lane / 16 * 8);
          mma_bf16_16816(acc[nd], ph, b[0], b[1]);
          mma_bf16_16816(acc[nd], pl, b[0], b[1]);
          mma_bf16_16816(acc[nd + 1], ph, b[2], b[3]);
          mma_bf16_16816(acc[nd + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // tile j's stage is free for tile j + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float denom = fmaxf(l[h], 1e-30f);
    if (lse != nullptr && tq == 0) lse[q_off / D + wrow + g + 8 * h] = m[h] + logf(denom);
    const int64_t o_off = q_off + static_cast<int64_t>(wrow + g + 8 * h) * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      uint32_t hi, lo;
      split_p(acc[nd][2 * h] / denom, acc[nd][2 * h + 1] / denom, hi, lo);
      *reinterpret_cast<uint32_t*>(out + o_off + nd * 8) = hi;
      if (out_lo != nullptr) *reinterpret_cast<uint32_t*>(out_lo + o_off + nd * 8) = lo;
    }
  }
}

// ---- f32: scalar FMAs -------------------------------------------------

constexpr int kRows = 4;         // query rows per thread
constexpr int kColThreads = 16;  // threads across the kv / head-dim axis

template <int BQ, int BKV, int D>
struct F32Tile {
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

template <int BQ, int BKV, int D>
__global__ void __launch_bounds__(F32Tile<BQ, BKV, D>::kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                     float* __restrict__ /* out_lo: f32 outputs are exact */, int hq, int hkv,
                     int seq, int causal, float scale) {
  using TL = F32Tile<BQ, BKV, D>;
  constexpr int CS = BKV / kColThreads;  // score columns per thread
  constexpr int CD = D / kColThreads;    // output columns per thread
  extern __shared__ float f32_smem[];
  float* qs = f32_smem;      // [BQ][D + 1]
  float* kt = qs + TL::kQ;   // [D][BKV + 1], K transposed
  float* vs = kt + TL::kKt;  // [BKV][D]
  float* ps = vs + TL::kV;   // [BQ][BKV + 1]

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int row0 = (tid / kColThreads) * kRows;  // first of this thread's query rows
  const int head = blockIdx.x;
  const int batch = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * BQ;
  const int kv_head = head / (hq / hkv);
  const int64_t q_off = ((static_cast<int64_t>(batch) * hq + head) * seq + q0) * D;
  const int64_t kv_off = (static_cast<int64_t>(batch) * hkv + kv_head) * seq * D;

  for (int i = tid; i < BQ * D; i += TL::kThreads) qs[(i / D) * (D + 1) + i % D] = q[q_off + i];

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
      kt[(i % D) * (BKV + 1) + i / D] = k[tile_off + i];
      vs[i] = v[tile_off + i];
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
    if (lse != nullptr && tx == 0) lse[o_off / D + a] = m[a] + logf(denom);
#pragma unroll
    for (int e = 0; e < CD; ++e) out[o_off + a * D + tx + kColThreads * e] = acc[a][e] / denom;
  }
}

// ---- launch -----------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  void* out_lo;
  int batch, hq, hkv, seq, causal;
  float scale;
  cudaStream_t stream;
};

// the kernel, its block and its shared memory for one input type: bf16 on
// the tensor cores, f32 on the FMA pipe
template <typename T, int BQ, int BKV, int D>
struct Kernel {
  static constexpr bool kTc = std::is_same<T, bf16>::value;
  static constexpr int kThreads = kTc ? TcTile<BQ, BKV, D>::kThreads : F32Tile<BQ, BKV, D>::kThreads;
  static constexpr int kBytes = kTc ? TcTile<BQ, BKV, D>::kBytes : F32Tile<BQ, BKV, D>::kBytes;
  static auto fn() {
    if constexpr (kTc)
      return flash_tc_kernel<BQ, BKV, D>;
    else
      return flash_f32_kernel<BQ, BKV, D>;
  }
};

template <typename T, int BQ, int BKV, int D>
int launch_tile(const Args& a) {
  using KN = Kernel<T, BQ, BKV, D>;
  auto kernel = KN::fn();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KN::kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // do not leave the error for the next launch's check
    return static_cast<int>(err);
  }
  const dim3 grid(a.hq, a.batch, a.seq / BQ);
  kernel<<<grid, KN::kThreads, KN::kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), a.lse, static_cast<T*>(a.out_lo), a.hq, a.hkv, a.seq, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

struct Attrs {
  cudaFuncAttributes func;
  int smem_bytes;
};

template <typename T, int BQ, int BKV, int D>
int attrs_tile(Attrs* out) {
  using KN = Kernel<T, BQ, BKV, D>;
  out->smem_bytes = KN::kBytes;
  return static_cast<int>(cudaFuncGetAttributes(&out->func, KN::fn()));
}

// Calls F<T, BQ, BKV, D>(arg) for the compiled (block_q, block_kv) tiles;
// kernels/attention/ops.py orders them by their time on the card.
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
    case 16: return launch_d<T, 16>(bq, bkv, a);
    case 32: return launch_d<T, 32>(bq, bkv, a);
    case 64: return launch_d<T, 64>(bq, bkv, a);
    case 112: return launch_d<T, 112>(bq, bkv, a);
    case 128: return launch_d<T, 128>(bq, bkv, a);
    case 160: return launch_d<T, 160>(bq, bkv, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int attrs_typed(int d, int bq, int bkv, Attrs* out) {
  switch (d) {
    case 16: return attrs_d<T, 16>(bq, bkv, out);
    case 32: return attrs_d<T, 32>(bq, bkv, out);
    case 64: return attrs_d<T, 64>(bq, bkv, out);
    case 112: return attrs_d<T, 112>(bq, bkv, out);
    case 128: return attrs_d<T, 128>(bq, bkv, out);
    case 160: return attrs_d<T, 160>(bq, bkv, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  q, out: (batch, hq, seq, d); k, v: (batch, hkv,
// seq, d), all contiguous.  lse: null, or (batch, hq, seq) f32 that receives
// each row's log-sum-exp m + log(max(l, 1e-30)) of the scaled, masked
// logits, which the backward (flash_attention_bwd.cu) recomputes P from.
// out_lo: null, or for bf16 a second (batch, hq, seq, d) bf16 output that
// receives bf16(o - out), o the f32 result, so that out + out_lo holds o to
// about 2^-16 of its value (ignored for f32, whose out is o).  Returns
// cudaGetLastError() after the launch (0 on success); argument errors
// return cudaErrorInvalidValue.
int flash_attention_launch(int dtype, int d, int block_q, int block_kv, const void* q,
                           const void* k, const void* v, void* out, void* lse, void* out_lo,
                           int batch, int hq, int hkv, int seq, int causal, float scale,
                           void* stream) {
  if (batch < 1 || hkv < 1 || hq % hkv || seq % block_q || seq % block_kv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, static_cast<float*>(lse), out_lo, batch, hq, hkv, seq, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_typed<float>(d, block_q, block_kv, a);
    case 1: return launch_typed<bf16>(d, block_q, block_kv, a);
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
    case 1: err = attrs_typed<bf16>(d, block_q, block_kv, &a); break;
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
