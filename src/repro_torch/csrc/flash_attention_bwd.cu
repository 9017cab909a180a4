// GQA flash-attention backward, for Hopper (sm_90a).
//
// The gradient of the forward in flash_attention.cu.  The TPU side has no
// backward kernel: the JAX package trains through its XLA reference
// attention (src/repro/models/layers.py, `attention`) and takes XLA's
// autodiff of it.  On the card every attention layer's forward runs the
// port's flash kernel, which keeps no probabilities, so the gradient is
// computed here from what that kernel saves: q, k, v, the output o and each
// row's log-sum-exp lse (written by the forward when it is given a pointer).
//
// With x = scale q k^T (masked where the forward masks) and P = exp(x - lse)
// recomputed tile by tile:
//   D  = rowsum(dO o o)                 (flash_attention_bwd_delta_kernel;
//                                        bf16: o = out + out_lo, the
//                                        forward's f32 result to ~2^-16)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dQ = scale dS K,  dK = scale dS^T Q
// GQA: dK and dV of kv head h sum over the group's q heads h * group ..
// (h + 1) * group - 1, as mha_plain's (batch, kv head) loop implies.
//
// Layout, with no atomics, so a step run twice gives the same gradients:
//   * a dK/dV kernel: one block per (kv head, batch, kv tile) loops over the
//     group's q heads in order and, inside, over the q tiles that see the kv
//     tile (all of them, or those on and below the diagonal under the
//     causal mask), and writes dK and dV once;
//   * a dQ kernel: one block per (q head, batch, q tile) loops over the kv
//     tiles the q tile sees and writes dQ once;
//   * before them, flash_attention_bwd_delta_kernel writes D, one warp a row
//     (kept as it was: it reads o, out_lo and dO once, a small share of
//     the time).
// Each of the two recomputes x and dP for its tile pairs, so x and dP are
// computed twice.
//
// Bound on the H100: operations (10 D flops per unmasked pair; at OLMo-1B's
// (4, 16, 16, 4096, 128) causal, 0.69 ms at 989 TFLOP/s in bf16 against
// 0.11 ms for the bytes).  What the design does about that, by input type:
//
// bf16 (the models' type) runs every product on the tensor cores.  P and dS
// are split in two bf16 halves, X_hi = bf16(x) and X_lo = bf16(x - X_hi),
// as the forward splits P: rounded once to bf16 either of them puts the
// gradients it feeds (dV for P; dQ and dK for dS) 6 to 23 times past the
// bf16 gradient rule at S >= 1024 (tests/test_torch_flash_bwd_split.py).
// So the products come to 20 D tensor-core flops per unmasked pair against
// the 10 D that the gradient needs: in dK/dV, K Q^T and V dO^T once (4 D)
// and P^T dO and dS^T Q twice each (8 D); in dQ, Q K^T and dO V^T again
// (4 D) and dS K twice (4 D).  The bound the design can reach is therefore
// twice the 10 D one.  Head dims 16, 32, 64, 112 and 128 run on Hopper's
// own path (see "bf16 on Hopper" below): wgmma from shared memory tiles that
// TMA fills, a producer warp and two consumer warpgroups.  Head dim 160
// keeps the mma.sync kernels of "bf16: mma.sync" below: its two 64 x 160
// f32 accumulators of dK and dV alone are 160 registers a thread.
//
// f32 keeps scalar f32 FMAs (flash_attention_bwd_dkdv_kernel,
// flash_attention_bwd_dq_kernel), as the forward keeps its f32 kernel: 14 D
// flops per pair, in register tiles of 4 x 4 (x, dP) and 4 rows x D / 16
// columns (the gradients), so each value read from shared memory feeds 2 to
// 2.7 FMAs.
//
// Padding.  The model pads S with zero rows before the kernel
// (models/layers.py, `attention`) and slices the output, so the padded
// rows' dO is zero: their D, dP and dS are zero and they add nothing to dK
// or dV.  Under the causal mask a real query never sees a padded key
// (key j > query i), so the real rows' gradients are those of the unpadded
// inputs.  Rows at or past `seq` inside a tile (S not a multiple of the
// tile) are staged as zeros and masked, P = 0, in every kernel.
//
// Shared memory per block of the f32 kernels, rows padded to D + 1 (odd, so
// the 16 rows that a half-warp reads at one column fall in distinct banks):
// dK/dV kernel Q, dO, K, V (64 x (D + 1) each), P and dS (64 x 65 each),
// lse and D (64 each): 198,656 B at D = 160; dQ kernel the same without P:
// 182,016 B.  One block of 256 threads per SM.  The bf16 kernels' layouts
// are stated at TcBwd and Hop.
#include "hopper.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;        // query and key rows of a tile
constexpr int kThreads = 256;
constexpr int kRows = 4;         // rows per thread in a register tile
constexpr int kColThreads = 16;  // threads across the columns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <int D>
struct Smem {
  static constexpr int kRow = D + 1;
  static constexpr int kMat = kTile * kRow;        // one of Q, dO, K, V
  static constexpr int kScores = kTile * (kTile + 1);  // P or dS
  static constexpr int kDkdvBytes = static_cast<int>(sizeof(float)) * (4 * kMat + 2 * kScores + 2 * kTile);
  static constexpr int kDqBytes = static_cast<int>(sizeof(float)) * (4 * kMat + kScores + 2 * kTile);
  static_assert(D % kColThreads == 0, "head dim must be a multiple of 16");
  static_assert(kDkdvBytes <= kMaxSmemBytes, "tile exceeds the shared memory of an H100 block");
};

// rows [row0, row0 + 64) of a (seq, D) matrix into dst [64][D + 1] as f32;
// rows at or past seq are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int seq) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < seq ? to_f32(src[static_cast<int64_t>(row0 + r) * D + c]) : 0.f;
  }
}

// rows [row0, row0 + 64) of a per-row f32 vector; rows at or past seq are 0
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int row0, int seq) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = row0 + i < seq ? src[row0 + i] : 0.f;
}

// P and dS of one (q tile, kv tile) pair for this thread's queries
// ty * 4 + a and keys tx + 16 c: x = scale q.k and dP = dO.v by scalar
// FMAs over d, then P = exp(x - lse) where the pair is kept (inside seq and,
// under the causal mask, key <= query), else 0, and dS = P (dP - D).
template <int D>
__device__ __forceinline__ void tile_scores(const float* qs, const float* dos, const float* ks,
                                            const float* vs, const float* lse_s, const float* dd_s,
                                            int q0, int k0, int seq, int causal, float scale,
                                            float (&p)[kRows][4], float (&ds)[kRows][4]) {
  constexpr int R = D + 1;
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  float s[kRows][4], dp[kRows][4];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[kRows], dov[kRows], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      qv[a] = qs[(ty * kRows + a) * R + d];
      dov[a] = dos[(ty * kRows + a) * R + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tx + kColThreads * c) * R + d];
      vv[c] = vs[(tx + kColThreads * c) * R + d];
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(dov[a], vv[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = ty * kRows + a, i = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + kColThreads * c;
      const bool keep = i < seq && j < seq && (!causal || j <= i);
      const float pv = keep ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
      p[a][c] = pv;
      ds[a][c] = pv * (dp[a][c] - dd_s[r]);
    }
  }
}

// D = rowsum(dO o o) in f32, one warp a row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ o_lo,
                                     const T* __restrict__ dout, float* __restrict__ delta,
                                     int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) {
    const int64_t i = row * D + c;
    const float ov = o_lo != nullptr ? to_f32(o[i]) + to_f32(o_lo[i]) : to_f32(o[i]);
    acc = fmaf(to_f32(dout[i]), ov, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const float* __restrict__ lse,
                                    const float* __restrict__ delta, const T* __restrict__ dout,
                                    T* __restrict__ dk, T* __restrict__ dv, int hq, int hkv,
                                    int seq, int causal, float scale) {
  using SM = Smem<D>;
  constexpr int R = D + 1;
  constexpr int E = D / kColThreads;  // gradient columns per thread
  extern __shared__ float dkdv_smem[];
  float* ks = dkdv_smem;
  float* vs = ks + SM::kMat;
  float* qs = vs + SM::kMat;
  float* dos = qs + SM::kMat;
  float* ps = dos + SM::kMat;  // [query][key], row kTile + 1
  float* dss = ps + SM::kScores;
  float* lse_s = dss + SM::kScores;
  float* dd_s = lse_s + kTile;

  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const int kv_head = blockIdx.x, batch = blockIdx.y;
  const int k0 = blockIdx.z * kTile;  // the first kv tiles see the most q tiles: they start first
  const int group = hq / hkv;
  const int64_t kv_off = (static_cast<int64_t>(batch) * hkv + kv_head) * seq * D;
  stage<T, D>(ks, k + kv_off, k0, seq);
  stage<T, D>(vs, v + kv_off, k0, seq);

  float acc_k[kRows][E], acc_v[kRows][E];  // keys ty * 4 + b, columns tx + 16 e
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_k[b][e] = acc_v[b][e] = 0.f;

  const int n_q = (seq + kTile - 1) / kTile;
  const int first_q = causal ? k0 / kTile : 0;
  for (int g = 0; g < group; ++g) {  // a fixed order over the group's q heads
    const int head = kv_head * group + g;
    const int64_t row_base = (static_cast<int64_t>(batch) * hq + head) * seq;
    for (int t = first_q; t < n_q; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous pair's Q, dO, P and dS are no longer read
      stage<T, D>(qs, q + row_base * D, q0, seq);
      stage<T, D>(dos, dout + row_base * D, q0, seq);
      stage_rows(lse_s, lse + row_base, q0, seq);
      stage_rows(dd_s, delta + row_base, q0, seq);
      __syncthreads();
      float p[kRows][4], ds[kRows][4];
      tile_scores<D>(qs, dos, ks, vs, lse_s, dd_s, q0, k0, seq, causal, scale, p, ds);
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty * kRows + a) * (kTile + 1) + tx + kColThreads * c] = p[a][c];
          dss[(ty * kRows + a) * (kTile + 1) + tx + kColThreads * c] = ds[a][c];
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q for keys ty * 4 + b, columns tx + 16 e
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float pv[kRows], dsv[kRows], dov[E], qv[E];
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          pv[b] = ps[i * (kTile + 1) + ty * kRows + b];
          dsv[b] = dss[i * (kTile + 1) + ty * kRows + b];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          dov[e] = dos[i * R + tx + kColThreads * e];
          qv[e] = qs[i * R + tx + kColThreads * e];
        }
#pragma unroll
        for (int b = 0; b < kRows; ++b)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            acc_v[b][e] = fmaf(pv[b], dov[e], acc_v[b][e]);
            acc_k[b][e] = fmaf(dsv[b], qv[e], acc_k[b][e]);
          }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    const int j = k0 + ty * kRows + b;
    if (j >= seq) continue;
    const int64_t off = kv_off + static_cast<int64_t>(j) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[off + tx + kColThreads * e] = static_cast<T>(acc_k[b][e] * scale);
      dv[off + tx + kColThreads * e] = static_cast<T>(acc_v[b][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const float* __restrict__ lse,
                                  const float* __restrict__ delta, const T* __restrict__ dout,
                                  T* __restrict__ dq, int hq, int hkv, int seq, int causal,
                                  float scale) {
  using SM = Smem<D>;
  constexpr int R = D + 1;
  constexpr int E = D / kColThreads;
  extern __shared__ float dq_smem[];
  float* qs = dq_smem;
  float* dos = qs + SM::kMat;
  float* ks = dos + SM::kMat;
  float* vs = ks + SM::kMat;
  float* dss = vs + SM::kMat;  // [query][key], row kTile + 1
  float* lse_s = dss + SM::kScores;
  float* dd_s = lse_s + kTile;

  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const int head = blockIdx.x, batch = blockIdx.y;
  const int n_q = (seq + kTile - 1) / kTile;
  const int t = causal ? n_q - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int q0 = t * kTile;
  const int kv_head = head / (hq / hkv);
  const int64_t row_base = (static_cast<int64_t>(batch) * hq + head) * seq;
  const int64_t kv_off = (static_cast<int64_t>(batch) * hkv + kv_head) * seq * D;
  stage<T, D>(qs, q + row_base * D, q0, seq);
  stage<T, D>(dos, dout + row_base * D, q0, seq);
  stage_rows(lse_s, lse + row_base, q0, seq);
  stage_rows(dd_s, delta + row_base, q0, seq);

  float acc[kRows][E];  // queries ty * 4 + a, columns tx + 16 e
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[a][e] = 0.f;

  const int n_kv = causal ? t + 1 : n_q;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    stage<T, D>(ks, k + kv_off, k0, seq);
    stage<T, D>(vs, v + kv_off, k0, seq);
    __syncthreads();
    float p[kRows][4], ds[kRows][4];
    tile_scores<D>(qs, dos, ks, vs, lse_s, dd_s, q0, k0, seq, causal, scale, p, ds);
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty * kRows + a) * (kTile + 1) + tx + kColThreads * c] = ds[a][c];
    __syncthreads();
    // dQ += dS K for queries ty * 4 + a, columns tx + 16 e
#pragma unroll 2
    for (int jj = 0; jj < kTile; ++jj) {
      float dsv[kRows], kv[E];
#pragma unroll
      for (int a = 0; a < kRows; ++a) dsv[a] = dss[(ty * kRows + a) * (kTile + 1) + jj];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = ks[jj * R + tx + kColThreads * e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[a][e] = fmaf(dsv[a], kv[e], acc[a][e]);
    }
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int i = q0 + ty * kRows + a;
    if (i >= seq) continue;
#pragma unroll
    for (int e = 0; e < E; ++e)
      dq[(row_base + i) * D + tx + kColThreads * e] = static_cast<T>(acc[a][e] * scale);
  }
}

// ---- bf16: mma.sync (head dim 160) ---------------------------------------
//
// The first mma.sync kernels, kept for the one head dim that Hopper's path below does
// not take (its dK and dV accumulators do not fit a warpgroup's registers).
// The four products that are not elementwise run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), with the fragment layouts
// and ldmatrix loads of the forward (flash_attention.cu):
//   * dK/dV (flash_bwd_dkdv_tc_kernel): a block of 4 warps holds 64 keys,
//     16 a warp, of one (batch, kv head) in shared memory and steps over
//     the group's q heads and 32 queries at a time (Q, dO, lse and D staged
//     with cp.async in two stages).  Each warp computes x^T = K Q^T and
//     dP^T = V dO^T for its 16 keys (16 x 32 C fragments), P^T and dS^T
//     elementwise, and then dV += P^T dO and dK += dS^T Q with P^T and dS^T
//     taken from its registers as A fragments (the m16n8 C fragment layout
//     is the m16n8k16 A fragment's, as P in the forward);
//   * dQ (flash_bwd_dq_tc_kernel): a block of 4 warps holds 64 queries, 16
//     a warp, with their Q and dO fragments in registers, steps over 32 keys
//     at a time (K and V in two cp.async stages), computes x = Q K^T and
//     dP = dO V^T, then dS, and dQ += dS K.
// P and dS are split as stated at the top: 20 D tensor-core flops per
// unmasked pair.  Rows past `seq` are zero-filled by the copies and masked.
// The tiles need seq to be a multiple of 32, which the forward's tiles
// already ask.

// 16 bytes from global to shared memory, or 16 zero bytes where !valid
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and register m receives row lane / 4, columns 2 (lane % 4) and
// 2 (lane % 4) + 1 of matrix m (with .trans: rows 2 (lane % 4) and
// 2 (lane % 4) + 1 of column lane / 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
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

// the A fragments (hi and lo) of k step kk from the C fragments c[2 kk] and
// c[2 kk + 1] of a 16-row product
template <int N>
__device__ __forceinline__ void c_to_a(const float (&c)[N][4], int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

constexpr int kTcThreads = 128;  // 4 warps of 16 rows
constexpr int kTcBlock = 64;     // keys a dK/dV block holds, queries a dQ block holds
constexpr int kTcStep = 32;      // queries (dK/dV) or keys (dQ) staged a step

template <int D>
struct TcBwd {
  static constexpr int kRow = D + 8;  // bf16 per padded row: ldmatrix rows in distinct banks
  static constexpr int kBlockBytes = 2 * kTcBlock * kRow * 2;  // K and V, or Q and dO
  static constexpr int kStepBytes = 2 * kTcStep * kRow * 2;    // Q and dO, or K and V
  static constexpr int kDkdvBytes = kBlockBytes + 2 * (kStepBytes + 2 * kTcStep * 4);  // + lse, D
  static constexpr int kDqBytes = kBlockBytes + 2 * kStepBytes;
  static_assert(D % 16 == 0, "head dims are whole mma fragments");
  static_assert(kDkdvBytes <= kMaxSmemBytes, "tile exceeds the shared memory of an H100 block");
  // bf16 rows padded by 16 bytes, so the 8 rows an ldmatrix reads fall in
  // distinct banks; dK/dV: K and V (64 rows) and two stages of Q, dO (32
  // rows) with lse and D, 86,528 B at D = 160; dQ: Q and dO (64 rows) and
  // two stages of K, V (32 rows), 86,016 B.  Two blocks of 128 threads an SM.
};

// rows [row0, row0 + rows) of a (seq, D) bf16 matrix into dst [rows][D + 8]
// with cp.async; rows at or past seq are zeros
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* __restrict__ src, int row0, int rows,
                                          int seq) {
  constexpr int kPieces = D / 8;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < rows * kPieces; i += kTcThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool valid = row0 + r < seq;
    cp_async16(dst + r * (D + 8) + c, src + static_cast<int64_t>(valid ? row0 + r : 0) * D + c, valid);
  }
}

// rows [row0, row0 + n) of an f32 vector (n and row0 multiples of 4, seq of
// 32), zeros at or past seq
__device__ __forceinline__ void copy_vec(float* dst, const float* __restrict__ src, int row0, int n, int seq) {
  for (int i = threadIdx.x; i < n / 4; i += kTcThreads) {
    const bool valid = row0 + 4 * i < seq;
    cp_async16(dst + 4 * i, src + (valid ? row0 + 4 * i : 0), valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ lse,
                             const float* __restrict__ delta, const bf16* __restrict__ dout,
                             bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv, int seq,
                             int causal, float scale) {
  using TB = TcBwd<D>;
  constexpr int R = TB::kRow;
  constexpr int KD = D / 16;        // k steps over the head dim
  constexpr int ND = D / 8;         // n tiles over the head dim
  constexpr int NQ = kTcStep / 8;   // n tiles over a step's queries
  extern __shared__ __align__(16) unsigned char dkdv_tc_smem[];
  unsigned char* smem = dkdv_tc_smem;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64][R]
  bf16* vs = ks + kTcBlock * R;              // [64][R]
  // stage st: Q [32][R], dO [32][R], then lse [32] and D [32] in f32
  auto stage = [&](int st) {
    return reinterpret_cast<bf16*>(smem + TB::kBlockBytes + st * (TB::kStepBytes + 2 * kTcStep * 4));
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kv_head = blockIdx.x, batch = blockIdx.y;
  const int k0 = blockIdx.z * kTcBlock;  // the first kv tiles see the most q steps: they start first
  const int group = hq / hkv;
  const int64_t kv_rows = (static_cast<int64_t>(batch) * hkv + kv_head) * seq;
  copy_rows<D>(ks, k + kv_rows * D, k0, kTcBlock, seq);
  copy_rows<D>(vs, v + kv_rows * D, k0, kTcBlock, seq);
  cp_async_commit();

  const int n_steps = (seq + kTcStep - 1) / kTcStep;
  const int first = causal ? k0 / kTcStep : 0;  // the q steps that see this kv tile
  const int per_head = n_steps - first;
  const int total = group * per_head;
  auto load_step = [&](int it, int st) {
    const int head = kv_head * group + it / per_head;  // a fixed order over the group's q heads
    const int q0 = (first + it % per_head) * kTcStep;
    const int64_t rows = (static_cast<int64_t>(batch) * hq + head) * seq;
    bf16* qs = stage(st);
    copy_rows<D>(qs, q + rows * D, q0, kTcStep, seq);
    copy_rows<D>(qs + kTcStep * R, dout + rows * D, q0, kTcStep, seq);
    float* lse_s = reinterpret_cast<float*>(qs + 2 * kTcStep * R);
    copy_vec(lse_s, lse + rows, q0, kTcStep, seq);
    copy_vec(lse_s + kTcStep, delta + rows, q0, kTcStep, seq);
  };
  load_step(0, 0);
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;
  const int key0 = k0 + warp * 16;  // this warp's first key
  const int key[2] = {key0 + g, key0 + g + 8};

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) load_step(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this step have landed
    __syncthreads();
    const int q0 = (first + it % per_head) * kTcStep;
    const bf16* qs = stage(st);
    const bf16* dos = qs + kTcStep * R;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * kTcStep * R);
    const float* dd_s = lse_s + kTcStep;
    if (!causal || q0 + kTcStep - 1 >= key0) {  // else every query here precedes every key of the warp
      float pt[NQ][4], dst[NQ][4];  // P^T, dS^T: rows the warp's keys, columns the step's queries
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[nt][e] = dst[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        const int a_off = (warp * 16 + lane % 8 + (lane / 8) % 2 * 8) * R + kd * 16 + lane / 16 * 8;
        ldmatrix_x4(ka, ks + a_off);
        ldmatrix_x4(va, vs + a_off);
#pragma unroll
        for (int nt = 0; nt < NQ; nt += 2) {
          const int b_off = (nt * 8 + lane % 8 + lane / 16 * 8) * R + kd * 16 + (lane / 8) % 2 * 8;
          uint32_t b[4];
          ldmatrix_x4(b, qs + b_off);
          mma_bf16_16816(pt[nt], ka, b[0], b[1]);
          mma_bf16_16816(pt[nt + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, dos + b_off);
          mma_bf16_16816(dst[nt], va, b[0], b[1]);
          mma_bf16_16816(dst[nt + 1], va, b[2], b[3]);
        }
      }
      // element e of [nt]: key key[e / 2], query q0 + 8 nt + 2 tq + e % 2
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * tq + e % 2, i = q0 + qi, j = key[e / 2];
          const bool keep = i < seq && j < seq && (!causal || j <= i);
          const float pv = keep ? expf(pt[nt][e] * scale - lse_s[qi]) : 0.f;
          pt[nt][e] = pv;
          dst[nt][e] = pv * (dst[nt][e] - dd_s[qi]);
        }
      // dV += P^T dO and dK += dS^T Q, 16 queries at a time
#pragma unroll
      for (int kk = 0; kk < kTcStep / 16; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        c_to_a(pt, kk, ph, pl);
        c_to_a(dst, kk, sh, sl);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          const int b_off = (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * R + nd * 8 + lane / 16 * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, dos + b_off);
          mma_bf16_16816(acc_v[nd], ph, b[0], b[1]);
          mma_bf16_16816(acc_v[nd], pl, b[0], b[1]);
          mma_bf16_16816(acc_v[nd + 1], ph, b[2], b[3]);
          mma_bf16_16816(acc_v[nd + 1], pl, b[2], b[3]);
          ldmatrix_x4_trans(b, qs + b_off);
          mma_bf16_16816(acc_k[nd], sh, b[0], b[1]);
          mma_bf16_16816(acc_k[nd], sl, b[0], b[1]);
          mma_bf16_16816(acc_k[nd + 1], sh, b[2], b[3]);
          mma_bf16_16816(acc_k[nd + 1], sl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for step it + 2
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= seq) continue;
    const int64_t off = (kv_rows + key[h]) * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<uint32_t*>(dk + off + nd * 8) = pack_bf16(
          __float2bfloat16_rn(acc_k[nd][2 * h] * scale), __float2bfloat16_rn(acc_k[nd][2 * h + 1] * scale));
      *reinterpret_cast<uint32_t*>(dv + off + nd * 8) =
          pack_bf16(__float2bfloat16_rn(acc_v[nd][2 * h]), __float2bfloat16_rn(acc_v[nd][2 * h + 1]));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ lse,
                           const float* __restrict__ delta, const bf16* __restrict__ dout,
                           bf16* __restrict__ dq, int hq, int hkv, int seq, int causal, float scale) {
  using TB = TcBwd<D>;
  constexpr int R = TB::kRow;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NS = kTcStep / 8;  // n tiles over a step's keys
  extern __shared__ __align__(16) unsigned char dq_tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(dq_tc_smem);  // [64][R]
  bf16* dos = qs + kTcBlock * R;                    // [64][R]
  // stage st: K [32][R], then V [32][R]
  auto stage = [&](int st) { return dos + kTcBlock * R + st * 2 * kTcStep * R; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int head = blockIdx.x, batch = blockIdx.y;
  const int n_tiles = (seq + kTcBlock - 1) / kTcBlock;
  const int q0 = (causal ? n_tiles - 1 - blockIdx.z : blockIdx.z) * kTcBlock;  // longest first
  const int kv_head = head / (hq / hkv);
  const int64_t rows = (static_cast<int64_t>(batch) * hq + head) * seq;
  const int64_t kv_rows = (static_cast<int64_t>(batch) * hkv + kv_head) * seq;
  copy_rows<D>(qs, q + rows * D, q0, kTcBlock, seq);
  copy_rows<D>(dos, dout + rows * D, q0, kTcBlock, seq);
  cp_async_commit();
  auto load_step = [&](int j, int st) {
    bf16* kst = stage(st);
    copy_rows<D>(kst, k + kv_rows * D, j * kTcStep, kTcStep, seq);
    copy_rows<D>(kst + kTcStep * R, v + kv_rows * D, j * kTcStep, kTcStep, seq);
  };
  const int n_steps = (seq + kTcStep - 1) / kTcStep;
  const int n_kv = causal ? min(n_steps, (q0 + kTcBlock) / kTcStep) : n_steps;
  load_step(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  uint32_t qf[KD][4], df[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int a_off = (warp * 16 + lane % 8 + (lane / 8) % 2 * 8) * R + kd * 16 + lane / 16 * 8;
    ldmatrix_x4(qf[kd], qs + a_off);
    ldmatrix_x4(df[kd], dos + a_off);
  }
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};  // this thread's two queries
  float lse_r[2], dd_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = row[h] < seq ? lse[rows + row[h]] : 0.f;
    dd_r[h] = row[h] < seq ? delta[rows + row[h]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) load_step(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // step j has landed
    __syncthreads();
    const int k0 = j * kTcStep;
    const bf16* kst = stage(st);
    const bf16* vst = kst + kTcStep * R;
    if (!causal || k0 <= q0 + warp * 16 + 15) {  // else every key here follows every query of the warp
      float sc[NS][4], ds[NS][4];
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = ds[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int nt = 0; nt < NS; nt += 2) {
          const int b_off = (nt * 8 + lane % 8 + lane / 16 * 8) * R + kd * 16 + (lane / 8) % 2 * 8;
          uint32_t b[4];
          ldmatrix_x4(b, kst + b_off);
          mma_bf16_16816(sc[nt], qf[kd], b[0], b[1]);
          mma_bf16_16816(sc[nt + 1], qf[kd], b[2], b[3]);
          ldmatrix_x4(b, vst + b_off);
          mma_bf16_16816(ds[nt], df[kd], b[0], b[1]);
          mma_bf16_16816(ds[nt + 1], df[kd], b[2], b[3]);
        }
      }
      // element e of [nt]: query row[e / 2], key k0 + 8 nt + 2 tq + e % 2
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row[e / 2], jj = k0 + nt * 8 + 2 * tq + e % 2;
          const bool keep = i < seq && jj < seq && (!causal || jj <= i);
          const float pv = keep ? expf(sc[nt][e] * scale - lse_r[e / 2]) : 0.f;
          ds[nt][e] = pv * (ds[nt][e] - dd_r[e / 2]);
        }
      // dQ += dS K, 16 keys at a time
#pragma unroll
      for (int kk = 0; kk < kTcStep / 16; ++kk) {
        uint32_t sh[4], sl[4];
        c_to_a(ds, kk, sh, sl);
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, kst + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * R + nd * 8 + lane / 16 * 8);
          mma_bf16_16816(acc[nd], sh, b[0], b[1]);
          mma_bf16_16816(acc[nd], sl, b[0], b[1]);
          mma_bf16_16816(acc[nd + 1], sh, b[2], b[3]);
          mma_bf16_16816(acc[nd + 1], sl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for step j + 2
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= seq) continue;
    const int64_t off = (rows + row[h]) * D + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<uint32_t*>(dq + off + nd * 8) =
          pack_bf16(__float2bfloat16_rn(acc[nd][2 * h] * scale), __float2bfloat16_rn(acc[nd][2 * h + 1] * scale));
  }
}

// ---- bf16 on Hopper: wgmma, TMA and warp specialisation -------------------
//
// Head dims 16, 32, 64, 112 and 128.  A block is a producer warpgroup and
// two consumer warpgroups (384 threads, one block an SM):
//   * the producer warpgroup gives up registers (setmaxnreg.dec) and lane 0
//     of its first warp
//     issues every load as a TMA copy (cp.async.bulk.tensor) of a 3-D
//     tensor map (B H, S, D), completing on mbarriers.  A tile that reaches
//     past `seq` is zero-filled by the TMA unit and never reads the next
//     head's rows;
//   * the block's resident tiles (K and V in dK/dV, Q and dO in dQ; 128
//     rows each, 64 a consumer warpgroup) land once; the streamed tiles (Q,
//     dO, lse and D of 64 queries in dK/dV; K and V of 64 keys in dQ) go
//     through a ring of kStages stages, each with a full mbarrier (the
//     producer's expected bytes) and an empty one (one arrival per consumer
//     warp once its products have read the stage);
//   * each consumer warpgroup (setmaxnreg.inc) computes its 64 x 64 x^T and
//     dP^T (dK/dV) or x and dP (dQ) with wgmma.mma_async.m64n64k16, both
//     operands K-major in shared memory, bf16 in and f32 accumulate;
//   * P = exp2(x log2(e) - lse log2(e)) and dS in registers; the causal
//     mask and the rows at or past `seq` are applied only on the tiles that
//     the diagonal or `seq` crosses;
//   * P and dS split into hi and lo bf16 A fragments in registers (the
//     accumulator layout of wgmma is its A fragment layout), then
//     wgmma.mma_async.m64nDk16 with A from registers and B (dO, Q or K)
//     MN-major in shared memory: dV += P^T_hi dO + P^T_lo dO and
//     dK += dS^T_hi Q + dS^T_lo Q, or dQ += dS_hi K + dS_lo K.
// Shared memory tiles are stored as in a 128-byte (64-byte, 32-byte at head
// dims 32, 16) swizzled layout that TMA writes and wgmma reads: a 64-row
// tile is kNc chunks of kCw columns, each 64 rows of kW bytes.  The
// mbarrier, TMA, setmaxnreg, descriptor, wgmma and tensor-map helpers are
// in hopper.cuh, shared with the forward.  No atomics:
// dK/dV sum over the group's q heads and q tiles in a fixed order, dQ over
// the kv tiles in order.

constexpr int kHopBlock = kConsumers * kWgRows;          // keys (dK/dV) or queries (dQ) a block
constexpr int kStepRows = 64;                            // queries (dK/dV) or keys (dQ) a stage
constexpr int kStages = 3;

template <int D>
struct Hop {
  using W = Swizzle<D>;
  static constexpr int kCw = W::kCw, kW = W::kW, kNc = W::kNc;
  static constexpr int kTileBytes = W::tile_bytes(kStepRows);  // bytes of a 64-row tile
  static constexpr int kVec = kStepRows * 4;            // bytes of 64 rows of lse or D
  // dK/dV: K and V (two tiles each), Q and dO of each stage, lse and D of
  // each stage, then the mbarriers (K/V full, full[kStages], empty[kStages])
  static constexpr int kDkdvBars = 4 * kTileBytes + 2 * kStages * kTileBytes + 2 * kStages * kVec;
  static constexpr int kDkdvTx = 2 * kTileBytes + 2 * kVec;  // bytes a stage expects
  // dQ: Q and dO (two tiles each), K and V of each stage, the mbarriers
  static constexpr int kDqBars = 4 * kTileBytes + 2 * kStages * kTileBytes;
  static constexpr int kDqTx = 2 * kTileBytes;
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kDkdvBytes = 1024 + kDkdvBars + kBarBytes;  // + the base's alignment to 1024
  static constexpr int kDqBytes = 1024 + kDqBars + kBarBytes;
  static_assert(D % 16 == 0 && D <= 128, "Hopper's path takes head dims that are multiples of 16 up to 128");
  static_assert(kTileBytes % 1024 == 0, "tiles keep the 1024-byte alignment of the swizzle pattern");
  static_assert(kDkdvBytes <= kMaxSmemBytes && kDqBytes <= kMaxSmemBytes,
                "tiles exceed the shared memory of an H100 block");
  // d128: dK/dV 166,456 B (K, V 64 KB; three stages of Q, dO 96 KB, lse
  // and D 1.5 KB), dQ 164,920 B (Q, dO 64 KB; three stages of K, V 96 KB).
};

// dK and dV of 128 keys of one (batch, kv head): keys k0 + 64 wg .. for
// consumer warpgroup wg, over the group's q heads in order and, inside, the
// q tiles of 64 that see the keys, in order
template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_lse,
                                const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
                                bf16* __restrict__ dv, int hq, int hkv, int seq, int causal, float scale) {
  using H = Hop<D>;
  extern __shared__ unsigned char hop_dkdv_smem[];
  const uint32_t raw = smem_addr(hop_dkdv_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* base_ptr = hop_dkdv_smem + (base - raw);
  const uint32_t ks = base;                                // K: two tiles, one a warpgroup
  const uint32_t vs = ks + 2 * H::kTileBytes;              // V: the same
  const uint32_t qs = vs + 2 * H::kTileBytes;              // Q of stage st at qs + st * kTileBytes
  const uint32_t dos = qs + kStages * H::kTileBytes;       // dO of each stage
  const uint32_t lse_s = dos + kStages * H::kTileBytes;    // lse of stage st at lse_s + st * kVec
  const uint32_t dd_s = lse_s + kStages * H::kVec;         // D of each stage
  const uint32_t kv_full = base + H::kDkdvBars;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * kStages;

  const int kv_head = blockIdx.x, batch = blockIdx.y;
  const int k0 = blockIdx.z * kHopBlock;  // the first kv tiles see the most q tiles: they start first
  const int group = hq / hkv;
  const int bh_kv = batch * hkv + kv_head;
  const int n_q = (seq + kStepRows - 1) / kStepRows;
  const int first = causal ? k0 / kStepRows : 0;  // the q tiles that see this kv tile
  const int per_head = n_q - first;
  const int total = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warpgroup
    regs_release<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect(kv_full, 4 * H::kTileBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < H::kNc; ++c) {
          const uint32_t off = half * H::kTileBytes + c * kStepRows * H::kW;
          tma_load_3d(ks + off, &tm_k, c * H::kCw, k0 + half * kWgRows, bh_kv, kv_full);
          tma_load_3d(vs + off, &tm_v, c * H::kCw, k0 + half * kWgRows, bh_kv, kv_full);
        }
      for (int it = 0; it < total; ++it) {
        const int st = it % kStages;
        mbar_wait(empty0 + 8 * st, ((it / kStages) & 1) ^ 1);
        const int bh = batch * hq + kv_head * group + it / per_head;  // a fixed order over the group's q heads
        const int q0 = (first + it % per_head) * kStepRows;
        const uint32_t full = full0 + 8 * st;
        mbar_expect(full, H::kDkdvTx);
        for (int c = 0; c < H::kNc; ++c) {
          const uint32_t off = st * H::kTileBytes + c * kStepRows * H::kW;
          tma_load_3d(qs + off, &tm_q, c * H::kCw, q0, bh, full);
          tma_load_3d(dos + off, &tm_do, c * H::kCw, q0, bh, full);
        }
        tma_load_2d(lse_s + st * H::kVec, &tm_lse, q0, bh, full);
        tma_load_2d(dd_s + st * H::kVec, &tm_delta, q0, bh, full);
      }
    }
  } else {  // consumer warpgroup wg: keys key0 .. key0 + 63
    regs_claim<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    const int key0 = k0 + wg * kWgRows;
    const uint32_t k_tile = ks + wg * H::kTileBytes, v_tile = vs + wg * H::kTileBytes;
    const float c2 = scale * kLog2e;
    float acc_k[D / 2], acc_v[D / 2], xt[32], dpt[32];  // dK, dV; x^T then P^T; dP^T then dS^T
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < total; ++it) {
      const int st = it % kStages;
      const int q0 = (first + it % per_head) * kStepRows;
      mbar_wait(full0 + 8 * st, (it / kStages) & 1);
      if (!causal || q0 + kStepRows - 1 >= key0) {  // else every query of the tile precedes every key
        const uint64_t kb = opaque(desc_kmajor<D>(k_tile)), vb = opaque(desc_kmajor<D>(v_tile));
        const uint64_t qb = desc_kmajor<D>(qs + st * H::kTileBytes), dob = desc_kmajor<D>(dos + st * H::kTileBytes);
        wgmma_fence();
        wgmma_scores<D, kStepRows, kStepRows>(xt, kb, qb);
        wgmma_commit();
        wgmma_scores<D, kStepRows, kStepRows>(dpt, vb, dob);
        wgmma_commit();
        const float* lse_r = reinterpret_cast<const float*>(base_ptr + (lse_s - base) + st * H::kVec);
        const float* dd_r = reinterpret_cast<const float*>(base_ptr + (dd_s - base) + st * H::kVec);
        const bool edge = (causal && q0 == key0) || q0 + kStepRows > seq || key0 + kWgRows > seq;
        wgmma_wait<1>();
        hold(xt);
        // P^T: element 4 j + 2 h + e is key key0 + 16 warp + g + 8 h, query q0 + 8 j + 2 tq + e
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_r + 8 * j + 2 * tq);
          const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              float p = exp2_approx(fmaf(xt[i], c2, -l2[e]));
              if (edge) {
                const int key = key0 + 16 * warp + g + 8 * h, qi = q0 + 8 * j + 2 * tq + e;
                if (qi >= seq || key >= seq || (causal && key > qi)) p = 0.f;
              }
              xt[i] = p;
            }
        }
        wgmma_wait<0>();
        hold(dpt);
        // dS^T = P^T (dP^T - D)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dd_r + 8 * j + 2 * tq);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dpt[4 * j + 2 * h] = xt[4 * j + 2 * h] * (dpt[4 * j + 2 * h] - dd.x);
            dpt[4 * j + 2 * h + 1] = xt[4 * j + 2 * h + 1] * (dpt[4 * j + 2 * h + 1] - dd.y);
          }
        }
        // dV += P^T dO, then dK += dS^T Q, 16 queries a step, each operand
        // in its hi and lo halves; dS^T is split while dV's products run
        split_acc(xt);
        const uint64_t dom = desc_mnmajor<D, kStepRows>(dos + st * H::kTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_split(acc_v, xt, kk, dom + mn_step<D>(kk));
        wgmma_commit();
        split_acc(dpt);
        const uint64_t qm = desc_mnmajor<D, kStepRows>(qs + st * H::kTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_split(acc_k, dpt, kk, qm + mn_step<D>(kk));
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc_v);
        hold(acc_k);
        hold(xt);
        hold(dpt);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 16 * warp + g + 8 * h;
      if (key >= seq) continue;
      const int64_t off = (static_cast<int64_t>(bh_kv) * seq + key) * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_bf16(
            __float2bfloat16_rn(acc_k[4 * j + 2 * h] * scale), __float2bfloat16_rn(acc_k[4 * j + 2 * h + 1] * scale));
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(__float2bfloat16_rn(acc_v[4 * j + 2 * h]), __float2bfloat16_rn(acc_v[4 * j + 2 * h + 1]));
      }
    }
  }
}

// dQ of 128 queries of one (batch, q head): queries q0 + 64 wg .. for
// consumer warpgroup wg, over the kv tiles of 64 that they see, in order
template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
                              int hq, int hkv, int seq, int causal, float scale) {
  using H = Hop<D>;
  extern __shared__ unsigned char hop_dq_smem[];
  const uint32_t raw = smem_addr(hop_dq_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t qs = base;                              // Q: two tiles, one a warpgroup
  const uint32_t dos = qs + 2 * H::kTileBytes;           // dO: the same
  const uint32_t ks = dos + 2 * H::kTileBytes;           // K of stage st at ks + st * kTileBytes
  const uint32_t vs = ks + kStages * H::kTileBytes;      // V of each stage
  const uint32_t qd_full = base + H::kDqBars;
  const uint32_t full0 = qd_full + 8, empty0 = full0 + 8 * kStages;

  const int head = blockIdx.x, batch = blockIdx.y;
  const int n_blocks = (seq + kHopBlock - 1) / kHopBlock;
  const int q0 = (causal ? n_blocks - 1 - blockIdx.z : blockIdx.z) * kHopBlock;  // longest first
  const int bh = batch * hq + head;
  const int bh_kv = batch * hkv + head / (hq / hkv);
  const int n_kv_all = (seq + kStepRows - 1) / kStepRows;
  const int n_kv = causal ? min(n_kv_all, (q0 + kHopBlock) / kStepRows) : n_kv_all;

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warpgroup
    regs_release<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect(qd_full, 4 * H::kTileBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < H::kNc; ++c) {
          const uint32_t off = half * H::kTileBytes + c * kStepRows * H::kW;
          tma_load_3d(qs + off, &tm_q, c * H::kCw, q0 + half * kWgRows, bh, qd_full);
          tma_load_3d(dos + off, &tm_do, c * H::kCw, q0 + half * kWgRows, bh, qd_full);
        }
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % kStages;
        mbar_wait(empty0 + 8 * st, ((j / kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect(full, H::kDqTx);
        for (int c = 0; c < H::kNc; ++c) {
          const uint32_t off = st * H::kTileBytes + c * kStepRows * H::kW;
          tma_load_3d(ks + off, &tm_k, c * H::kCw, j * kStepRows, bh_kv, full);
          tma_load_3d(vs + off, &tm_v, c * H::kCw, j * kStepRows, bh_kv, full);
        }
      }
    }
  } else {  // consumer warpgroup wg: queries qw .. qw + 63
    regs_claim<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    const int qw = q0 + wg * kWgRows;
    const uint32_t q_tile = qs + wg * H::kTileBytes, do_tile = dos + wg * H::kTileBytes;
    const float c2 = scale * kLog2e;
    int row[2];
    float l2[2], dd[2];  // this thread's two queries: lse log2(e) and D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = qw + 16 * warp + g + 8 * h;
      l2[h] = row[h] < seq ? lse[static_cast<int64_t>(bh) * seq + row[h]] * kLog2e : 0.f;
      dd[h] = row[h] < seq ? delta[static_cast<int64_t>(bh) * seq + row[h]] : 0.f;
    }
    float acc[D / 2], sc[32], ds[32];  // dQ; x then P; dP then dS
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qd_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int st = j % kStages;
      const int kv0 = j * kStepRows;
      mbar_wait(full0 + 8 * st, (j / kStages) & 1);
      if (!causal || kv0 <= qw + kWgRows - 1) {  // else every key of the tile follows every query
        const uint64_t qb = opaque(desc_kmajor<D>(q_tile)), dob = opaque(desc_kmajor<D>(do_tile));
        const uint64_t kb = desc_kmajor<D>(ks + st * H::kTileBytes), vb = desc_kmajor<D>(vs + st * H::kTileBytes);
        wgmma_fence();
        wgmma_scores<D, kStepRows, kStepRows>(sc, qb, kb);
        wgmma_commit();
        wgmma_scores<D, kStepRows, kStepRows>(ds, dob, vb);
        wgmma_commit();
        const bool edge = (causal && kv0 == qw) || qw + kWgRows > seq || kv0 + kStepRows > seq;
        wgmma_wait<1>();
        hold(sc);
        // P: element 4 j + 2 h + e is query row[h], key kv0 + 8 j + 2 tq + e
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * jj + 2 * h + e;
              float p = exp2_approx(fmaf(sc[i], c2, -l2[h]));
              if (edge) {
                const int key = kv0 + 8 * jj + 2 * tq + e;
                if (row[h] >= seq || key >= seq || (causal && key > row[h])) p = 0.f;
              }
              sc[i] = p;
            }
        wgmma_wait<0>();
        hold(ds);
#pragma unroll
        for (int i = 0; i < 32; ++i) ds[i] = sc[i] * (ds[i] - dd[(i / 2) % 2]);
        split_acc(ds);
        const uint64_t km = desc_mnmajor<D, kStepRows>(ks + st * H::kTileBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_split(acc, ds, kk, km + mn_step<D>(kk));  // dQ += dS K, 16 keys a step
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        hold(ds);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= seq) continue;
      const int64_t off = (static_cast<int64_t>(bh) * seq + row[h]) * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dq + off + 8 * jj) = pack_bf16(
            __float2bfloat16_rn(acc[4 * jj + 2 * h] * scale), __float2bfloat16_rn(acc[4 * jj + 2 * h + 1] * scale));
    }
  }
}

// -- the tensor maps (host)

// (bh, seq) f32 per-row values, boxes of 64 rows
inline int map_vec(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh, int seq) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(seq) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStepRows), 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box,
                              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(res);
}

// ---- launch -----------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *o_lo, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int batch, hq, hkv, seq, causal;
  float scale;
  cudaStream_t stream;
};

// the kernels, blocks and shared memory for one input type and head dim:
// bf16 on Hopper's path up to D = 128 and on mma.sync at 160, f32 on the
// FMA pipe
template <typename T, int D>
struct Kernels {
  static constexpr bool kTc = std::is_same<T, bf16>::value;
  static constexpr bool kHop = kTc && D <= 128;
  static constexpr int dkdv_bytes() {
    if constexpr (kHop)
      return Hop<D>::kDkdvBytes;
    else if constexpr (kTc)
      return TcBwd<D>::kDkdvBytes;
    else
      return Smem<D>::kDkdvBytes;
  }
  static constexpr int dq_bytes() {
    if constexpr (kHop)
      return Hop<D>::kDqBytes;
    else if constexpr (kTc)
      return TcBwd<D>::kDqBytes;
    else
      return Smem<D>::kDqBytes;
  }
  static auto dkdv() {
    if constexpr (kHop)
      return flash_bwd_dkdv_wgmma_kernel<D>;
    else if constexpr (kTc)
      return flash_bwd_dkdv_tc_kernel<D>;
    else
      return flash_attention_bwd_dkdv_kernel<T, D>;
  }
  static auto dq() {
    if constexpr (kHop)
      return flash_bwd_dq_wgmma_kernel<D>;
    else if constexpr (kTc)
      return flash_bwd_dq_tc_kernel<D>;
    else
      return flash_attention_bwd_dq_kernel<T, D>;
  }
};

// the dK/dV and dQ kernels of Hopper's path, after the D kernel
template <int D>
int launch_hopper(const Args& a) {
  using H = Hop<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bhq = a.batch * a.hq, bhkv = a.batch * a.hkv;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  int err;
  if ((err = map_rows<D>(encode, &tm_q, a.q, bhq, a.seq, kStepRows)) || (err = map_rows<D>(encode, &tm_k, a.k, bhkv, a.seq, kStepRows)) ||
      (err = map_rows<D>(encode, &tm_v, a.v, bhkv, a.seq, kStepRows)) ||
      (err = map_rows<D>(encode, &tm_do, a.dout, bhq, a.seq, kStepRows)) ||
      (err = map_vec(encode, &tm_lse, a.lse, bhq, a.seq)) || (err = map_vec(encode, &tm_delta, a.delta, bhq, a.seq)))
    return err;
  const unsigned n_blocks = static_cast<unsigned>((a.seq + kHopBlock - 1) / kHopBlock);
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D>;
  if ((err = allow_smem(dkdv, H::kDkdvBytes))) return err;
  dkdv<<<dim3(a.hkv, a.batch, n_blocks), kHopThreads, H::kDkdvBytes, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.hq, a.hkv,
      a.seq, a.causal, a.scale);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  auto dq = flash_bwd_dq_wgmma_kernel<D>;
  if ((err = allow_smem(dq, H::kDqBytes))) return err;
  dq<<<dim3(a.hq, a.batch, n_blocks), kHopThreads, H::kDqBytes, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.hq, a.hkv, a.seq, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const Args& a) {
  using KN = Kernels<T, D>;
  if (KN::kTc && a.seq % kTcStep) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(a.batch) * a.hq * a.seq;
  flash_attention_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.o), static_cast<const T*>(a.o_lo), static_cast<const T*>(a.dout),
          static_cast<float*>(a.delta), rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if constexpr (KN::kHop) {
    return launch_hopper<D>(a);
  } else {
    constexpr int threads = KN::kTc ? kTcThreads : kThreads, tile = KN::kTc ? kTcBlock : kTile;
    const int n_tiles = (a.seq + tile - 1) / tile;
    auto dkdv = KN::dkdv();
    if ((err = allow_smem(dkdv, KN::dkdv_bytes()))) return err;
    dkdv<<<dim3(a.hkv, a.batch, n_tiles), threads, KN::dkdv_bytes(), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.hq, a.hkv,
        a.seq, a.causal, a.scale);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    auto dq = KN::dq();
    if ((err = allow_smem(dq, KN::dq_bytes()))) return err;
    dq<<<dim3(a.hq, a.batch, n_tiles), threads, KN::dq_bytes(), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.hq, a.hkv, a.seq, a.causal, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
}

struct Attrs {
  cudaFuncAttributes func;
  int smem_bytes;
};

// which: 0 = delta, 1 = dK/dV, 2 = dQ
template <typename T, int D>
int attrs_d(int which, Attrs* out) {
  using KN = Kernels<T, D>;
  switch (which) {
    case 0:
      out->smem_bytes = 0;
      return static_cast<int>(cudaFuncGetAttributes(&out->func, flash_attention_bwd_delta_kernel<T, D>));
    case 1:
      out->smem_bytes = KN::dkdv_bytes();
      return static_cast<int>(cudaFuncGetAttributes(&out->func, KN::dkdv()));
    case 2:
      out->smem_bytes = KN::dq_bytes();
      return static_cast<int>(cudaFuncGetAttributes(&out->func, KN::dq()));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the head dims the forward compiles (kernels/attention/kernel.py HEAD_DIMS)
#define BWD_HEAD_DIMS(F, T, D_, ...)                          \
  switch (D_) {                                               \
    case 16: return F<T, 16>(__VA_ARGS__);                    \
    case 32: return F<T, 32>(__VA_ARGS__);                    \
    case 64: return F<T, 64>(__VA_ARGS__);                    \
    case 112: return F<T, 112>(__VA_ARGS__);                  \
    case 128: return F<T, 128>(__VA_ARGS__);                  \
    case 160: return F<T, 160>(__VA_ARGS__);                  \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

template <typename T>
int launch_typed(int d, const Args& a) {
  BWD_HEAD_DIMS(launch_d, T, d, a)
}

template <typename T>
int attrs_typed(int d, int which, Attrs* out) {
  BWD_HEAD_DIMS(attrs_d, T, d, which, out)
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  q, o, dout, dq: (batch, hq, seq, d); o_lo:
// null, or the forward's rounding error of o, the same shape; k, v, dk, dv:
// (batch, hkv, seq, d); lse and delta (scratch, written here): (batch, hq,
// seq) f32; all contiguous (bf16 at head dims up to 128: 16-byte aligned,
// as TMA reads them).  Launches the three kernels in order on `stream`;
// returns cudaGetLastError() after them (0 on success),
// cudaErrorInvalidValue for arguments the kernels do not take,
// cudaErrorNotSupported where the driver has no cuTensorMapEncodeTiled, or
// 100000 + the CUresult where it refuses a tensor map.
int flash_attention_bwd_launch(int dtype, int d, const void* q, const void* k, const void* v,
                               const void* o, const void* o_lo, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv, void* delta,
                               int batch, int hq, int hkv, int seq, int causal, float scale,
                               void* stream) {
  if (batch < 1 || hkv < 1 || seq < 1 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, o_lo, lse, dout, dq, dk, dv, delta, batch, hq, hkv, seq, causal, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_typed<float>(d, a);
    case 1: return launch_typed<bf16>(d, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers and local (spill) bytes per thread, the largest block, and the
// dynamic shared memory of one of the three kernels (which: 0 = delta,
// 1 = dK/dV, 2 = dQ) at (dtype, d).
int flash_attention_bwd_attributes(int dtype, int d, int which, int* regs, int* local_bytes,
                                   int* max_threads, int* smem_bytes) {
  Attrs a;
  int err;
  switch (dtype) {
    case 0: err = attrs_typed<float>(d, which, &a); break;
    case 1: err = attrs_typed<bf16>(d, which, &a); break;
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
