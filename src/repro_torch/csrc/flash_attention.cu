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
//     and is never fully masked).  The same holds for a consumer warpgroup
//     whose 64 rows all lie above a kv tile: it skips that tile's products.
//
// Bound on the H100: operations.  The causal forward at S = 4096, D = 128
// does 4 * D flops per (query, key) pair against 2 bytes per element read
// once; at 989 TFLOP/s (bf16 tensor cores) the operation bound is six times
// the byte bound.  What the design does about that, by input type:
//
// bf16 (the models' type) runs on Hopper's own path: wgmma from shared
// memory tiles that TMA fills, with one producer warpgroup and two consumer
// warpgroups (flash_fwd_wgmma_kernel below; the building blocks are in
// hopper.cuh, shared with the backward):
//   * a block computes 128 query rows, 64 for each consumer warpgroup, of
//     one (batch, q head).  Lane 0 of the producer warpgroup loads Q once by
//     TMA from a 3-D tensor map (B Hq, S, D) and streams K and V of BKV keys
//     a stage through a ring of kStages stages; K and V of a stage land on
//     their own full mbarriers, so Q K^T starts before V has arrived, and
//     each stage has an empty mbarrier (one arrival per consumer warp once
//     its products have read the stage);
//   * S = Q K^T by wgmma.mma_async m64nBKVk16, both operands K-major in
//     shared memory, bf16 in and f32 accumulate;
//   * the online softmax runs on the accumulator fragments, in base 2: the
//     scale carries log2(e), so p = exp2(s c2 - m2) is one FMA and one ex2,
//     with m2 the running max of s c2.  The mask is applied only on the
//     tiles that the diagonal or `seq` crosses.  A thread holds two rows;
//     a row's max is taken over the 4 lanes of a quad each tile, its sum
//     only at the end (the lanes of a quad share the rescale factors);
//   * the two consumer warpgroups take turns on the tensor cores (two named
//     barriers): a turn is O += P_{j-1} V_{j-1}, then S_j = Q K_j^T, each
//     waited for at once, and the softmax of tile j runs after the turn,
//     under the other warpgroup's.  PERF.md times it against no turns,
//     against two turns a tile given away as soon as their products are
//     issued, and against the softmax of tile j run under the next tile's
//     Q K^T in the same warpgroup (two more register tiles): one turn a
//     tile was the fastest at S >= 2560, and 5 % slower than no turns at
//     S = 512;
//   * P stays in registers.  The TPU kernel keeps p in f32, and P rounded
//     once to bf16 fails the bf16 attention rule at S = 4096 (the port's
//     PERF.md).  So P is split, P_hi = bf16(p), P_lo = bf16(p - P_hi), into
//     the A fragments of O += P_hi V + P_lo V by wgmma m64nDk16 with A from
//     registers and V MN-major in shared memory: 6 D tensor-core flops a
//     pair against the 4 D of the function, with p kept to about 2^-17 of
//     its value.  l is summed from the f32 p;
//   * causal q tiles run longest first (the q tile is the grid's slowest
//     axis, reversed), so the short tiles of the causal tail fill the last
//     wave.
// Any S: the TMA unit zero-fills rows past `seq`, keys past `seq` are
// masked, and rows past `seq` are not stored.
// f32 keeps the scalar kernel: TF32 on the tensor cores would miss the f32
// limit of 3e-5 that this path meets (8.94e-7, the port's PERF.md), and the
// models' path is bf16.  Each thread holds a 4-row register tile of scores
// and of the accumulator, so every value loaded from shared memory feeds 4
// to 8 FMAs; K is stored transposed and Q, K and P with a padded row.  Its
// tiles must divide S.
//
// Head dims.  Both kernels compile 16 (the models' smoke configs), 32, 64,
// 112 (Zamba2-7B), 128 (Qwen2.5-14B) and 160 (StableLM-12B).  bf16 tiles
// are (128, 64) at every head dim and (128, 128) up to 128: at 160 Q and two
// stages of 128-row K and V tiles would exceed 227 KB.  f32 tiles are (32,
// 32), (64, 32), (64, 64) and (128, 64).
//
// What training adds.  Given an `lse` pointer (the autograd Function of
// kernels/attention/kernel.py), each row's m + log(max(l, 1e-30)) is
// written in f32 in natural-log units (bf16: m2 ln 2 + log(max(l, 1e-30))),
// so that the backward (flash_attention_bwd.cu) recomputes P = exp(x - lse)
// without a second pass over the keys.  Given `out_lo` (bf16), the output's
// rounding error bf16(o - bf16(o)) is written beside it, split as P is: the
// backward's D = rowsum(dO o o) from the rounded output alone misses the
// plain version's gradient by 20 to 35 times ATTN_GRAD_RULE where a causal
// row sees few keys (chip_smoke.py's `without_out_lo`).  The serving path
// passes null for both and writes nothing more.  No atomics: two launches
// give the same bits.
//
// Shared memory per block.  bf16 (Fwd below): Q (two 64-row tiles), then
// kStages stages of a K and a V tile of BKV rows, in the swizzled layout of
// hopper.cuh, then the mbarriers: 230,480 B at (128, 128), D = 128 (three
// stages); one block of 384 threads an SM.  f32: Q (BQ x (D+1)), K^T
// (D x (BKV+1)), V (BKV x D), P (BQ x (BKV+1)), in f32: at most 198,272 B,
// at (128, 64), D = 160.  Both are dynamic shared memory, allowed per
// instantiation with cudaFuncSetAttribute.  flash_attention_attributes
// reports it, and a tile that would exceed the 227 KB a block can have does
// not compile.
#include "hopper.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// max or sum over the 4 lanes of a quad, which hold one row of a fragment
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// named barrier `id` (1 and 2; 0 is __syncthreads') over the two consumer
// warpgroups: one waits on its own, the other arrives on it
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers * 128) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers * 128) : "memory");
}

// ---- bf16 on Hopper: wgmma, TMA and warp specialisation -------------------

constexpr int kBlockQ = kConsumers * kWgRows;  // query rows a block
constexpr int kMaxStages = 4;

// (128, BKV) tiles at head dim D: their shared memory, and as many stages
// of K and V (up to kMaxStages) as fit beside Q
template <int D, int BKV>
struct Fwd {
  using W = Swizzle<D>;
  static constexpr int kQTile = W::tile_bytes(kWgRows);  // one consumer's 64 rows of Q
  static constexpr int kKvTile = W::tile_bytes(BKV);     // one K or V tile
  static constexpr int kFree = kMaxSmemBytes - 1024 - 2 * kQTile - 8 * (1 + 3 * kMaxStages);
  static constexpr int kStages = kFree / (2 * kKvTile) < kMaxStages ? kFree / (2 * kKvTile) : kMaxStages;
  // Q, K and V of each stage, then the mbarriers (Q full, K full[kStages],
  // V full[kStages], empty[kStages])
  static constexpr int kBars = 2 * kQTile + 2 * kStages * kKvTile;
  static constexpr int kBytes = 1024 + kBars + 8 * (1 + 3 * kStages);  // + the base's alignment to 1024
  static_assert(BKV == 64 || BKV == 128, "wgmma's n is the kv tile: 64 or 128");
  static_assert(kStages >= 2, "the tile leaves no room for two stages of K and V");
  static_assert(kBytes <= kMaxSmemBytes, "tile exceeds the shared memory of an H100 block");
};

// whether the (128, BKV) tile is compiled at head dim D
template <int D, int BKV>
constexpr bool kFwdTile = BKV == 64 || (BKV == 128 && D <= 128);

// Attention of 128 queries of one (batch, q head): queries q0 + 64 wg ..
// for consumer warpgroup wg, over the kv tiles of BKV keys that they see,
// in order
template <int D, int BKV>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                           float* __restrict__ lse, bf16* __restrict__ out_lo, int hq, int hkv, int seq,
                           int causal, float scale) {
  using F = Fwd<D, BKV>;
  using W = Swizzle<D>;
  constexpr int S = F::kStages;
  extern __shared__ unsigned char fwd_smem[];
  const uint32_t base = (smem_addr(fwd_smem) + 1023) & ~1023u;
  const uint32_t qs = base;                    // Q: two tiles, one a consumer warpgroup
  const uint32_t ks = qs + 2 * F::kQTile;      // K of stage st at ks + st * kKvTile
  const uint32_t vs = ks + S * F::kKvTile;     // V of each stage
  const uint32_t q_full = base + F::kBars;
  const uint32_t k_full0 = q_full + 8, v_full0 = k_full0 + 8 * S, empty0 = v_full0 + 8 * S;

  const int head = blockIdx.x, batch = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * kBlockQ;  // longest first
  const int bh = batch * hq + head;
  const int bh_kv = batch * hkv + head / (hq / hkv);
  const int n_kv_all = (seq + BKV - 1) / BKV;
  const int n_kv = causal ? min(n_kv_all, (q0 + kBlockQ + BKV - 1) / BKV) : n_kv_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full0 + 8 * st, 1);
      mbar_init(v_full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warpgroup
    regs_release<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect(q_full, 2 * F::kQTile);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < W::kNc; ++c)
          tma_load_3d(qs + half * F::kQTile + c * kWgRows * W::kW, &tm_q, c * W::kCw, q0 + half * kWgRows, bh,
                      q_full);
      for (int j = 0; j < n_kv; ++j) {
        const int st = j % S;
        mbar_wait(empty0 + 8 * st, ((j / S) & 1) ^ 1);
        const uint32_t k_full = k_full0 + 8 * st, v_full = v_full0 + 8 * st;
        mbar_expect(k_full, F::kKvTile);
        for (int c = 0; c < W::kNc; ++c)
          tma_load_3d(ks + st * F::kKvTile + c * BKV * W::kW, &tm_k, c * W::kCw, j * BKV, bh_kv, k_full);
        mbar_expect(v_full, F::kKvTile);
        for (int c = 0; c < W::kNc; ++c)
          tma_load_3d(vs + st * F::kKvTile + c * BKV * W::kW, &tm_v, c * W::kCw, j * BKV, bh_kv, v_full);
      }
    }
  } else {  // consumer warpgroup wg: queries qw .. qw + 63
    regs_claim<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tq = lane % 4;
    const int qw = q0 + wg * kWgRows;
    const int row[2] = {qw + 16 * warp + g, qw + 16 * warp + g + 8};  // this thread's two queries
    const uint32_t q_tile = qs + wg * F::kQTile;
    const float c2 = scale * kLog2e;
    // the tiles this warpgroup computes, a prefix of the block's: under the
    // causal mask those that hold a key at or before its last query; none
    // where every query lies past seq
    const int n_mine = qw >= seq ? 0 : causal ? min(n_kv, (qw + kWgRows - 1) / BKV + 1) : n_kv;
    // O; S = Q K^T of a tile, then its p, then its P fragments; the running
    // max of s c2 and this thread's share of each row's sum
    float acc[D / 2], sc[BKV / 2];
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    if (wg == 1) named_arrive(1);  // warpgroup 0 takes the first turn
    // Step j computes O += P_{j-1} V_{j-1} and then S_j = Q K_j^T in this
    // warpgroup's turn, and the softmax of tile j after it, while the other
    // warpgroup's products hold the tensor cores.  Both warpgroups take
    // n_kv + 1 steps, so that their turns pair up; a step past this
    // warpgroup's tiles computes nothing
    for (int j = 0; j <= n_kv; ++j) {
      const int st = j % S, prev = (j + S - 1) % S;
      const bool pv = j > 0 && j <= n_mine, qk = j < n_mine;
      if (pv) mbar_wait(v_full0 + 8 * prev, ((j - 1) / S) & 1);
      if (qk) mbar_wait(k_full0 + 8 * st, (j / S) & 1);
      named_sync(1 + wg);
      if (pv) {  // O += P_hi V + P_lo V, 16 keys a step
        const uint64_t vm = desc_mnmajor<D, BKV>(vs + prev * F::kKvTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) wgmma_split(acc, sc, kk, vm + mn_step<D>(kk));
        wgmma_commit();
        wgmma_wait<0>();
        hold(acc);
        hold(sc);
      }
      if (qk) {
        const uint64_t qb = opaque(desc_kmajor<D>(q_tile)), kb = desc_kmajor<D>(ks + st * F::kKvTile);
        wgmma_fence();
        wgmma_scores<D, kWgRows, BKV>(sc, qb, kb);
        wgmma_commit();
        wgmma_wait<0>();
        hold(sc);
      }
      // the other warpgroup's turn (warpgroup 1's last step has no turn to give)
      if (!(wg == 1 && j == n_kv)) named_arrive(2 - wg);
      if (pv) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);  // this warp is done with tile j - 1's stage
      }
      if (j >= n_mine && j < n_kv) {
        // a tile of the block that this warpgroup skips: once it has landed
        // (so both warpgroups have released the stage's previous tile),
        // this warpgroup's arrival belongs to it
        mbar_wait(k_full0 + 8 * st, (j / S) & 1);
        mbar_wait(v_full0 + 8 * st, (j / S) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * st);
      }
      if (qk) {
        const int k0 = j * BKV;
        // element 4 jj + 2 h + e is query row[h], key k0 + 8 jj + 2 tq + e
        const bool edge = (causal && k0 + BKV - 1 > qw) || k0 + BKV > seq;
        if (edge) {
#pragma unroll
          for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = k0 + 8 * jj + 2 * tq + e;
                if (key >= seq || (causal && key > row[h])) sc[4 * jj + 2 * h + e] = kNegInf;
              }
        }
        // element i is row (i / 2) % 2; two partial maxima and sums a row
        float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf}, sum[4] = {0.f, 0.f, 0.f, 0.f}, alpha[2];
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) mx[i % 4] = fmaxf(mx[i % 4], sc[i]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(m2[h], quad_max(fmaxf(mx[2 * h], mx[2 * h + 1])) * c2);
          alpha[h] = exp2_approx(m2[h] - m_new);
          m2[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          float p = exp2_approx(fmaf(sc[i], c2, -m2[(i / 2) % 2]));
          if (edge && sc[i] == kNegInf) p = 0.f;  // masked: p = 0 even where the row has seen no key yet
          sc[i] = p;
          sum[i % 4] += p;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + (sum[2 * h] + sum[2 * h + 1]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
        split_acc(sc);  // P's hi and lo fragments in place, for the next step's P V
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float denom = fmaxf(quad_sum(l[h]), 1e-30f);
      if (row[h] >= seq) continue;
      const int64_t r = static_cast<int64_t>(bh) * seq + row[h];
      if (lse != nullptr && tq == 0) lse[r] = m2[h] * kLn2 + logf(denom);
      const int64_t off = r * D + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        uint32_t hi, lo;
        split2(acc[4 * jj + 2 * h] / denom, acc[4 * jj + 2 * h + 1] / denom, hi, lo);
        *reinterpret_cast<uint32_t*>(out + off + 8 * jj) = hi;
        if (out_lo != nullptr) *reinterpret_cast<uint32_t*>(out_lo + off + 8 * jj) = lo;
      }
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

struct Attrs {
  cudaFuncAttributes func;
  int smem_bytes;
};

// bf16: the tensor maps, then flash_fwd_wgmma_kernel on (128, BKV) tiles
template <int D, int BKV>
int launch_wgmma(const Args& a) {
  using F = Fwd<D, BKV>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  int err;
  if ((err = map_rows<D>(encode, &tm_q, a.q, a.batch * a.hq, a.seq, kWgRows)) ||
      (err = map_rows<D>(encode, &tm_k, a.k, a.batch * a.hkv, a.seq, BKV)) ||
      (err = map_rows<D>(encode, &tm_v, a.v, a.batch * a.hkv, a.seq, BKV)))
    return err;
  auto kernel = flash_fwd_wgmma_kernel<D, BKV>;
  if ((err = allow_smem(kernel, F::kBytes))) return err;
  const dim3 grid(a.hq, a.batch, (a.seq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kHopThreads, F::kBytes, a.stream>>>(tm_q, tm_k, tm_v, static_cast<bf16*>(a.out), a.lse,
                                                     static_cast<bf16*>(a.out_lo), a.hq, a.hkv, a.seq, a.causal,
                                                     a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BKV>
int attrs_wgmma(Attrs* out) {
  out->smem_bytes = Fwd<D, BKV>::kBytes;
  return static_cast<int>(cudaFuncGetAttributes(&out->func, flash_fwd_wgmma_kernel<D, BKV>));
}

// f32: flash_f32_kernel on (BQ, BKV) tiles that divide seq
template <int D, int BQ, int BKV>
int launch_f32(const Args& a) {
  using TL = F32Tile<BQ, BKV, D>;
  auto kernel = flash_f32_kernel<BQ, BKV, D>;
  int err;
  if ((err = allow_smem(kernel, TL::kBytes))) return err;
  const dim3 grid(a.hq, a.batch, a.seq / BQ);
  kernel<<<grid, TL::kThreads, TL::kBytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<float*>(a.out), a.lse, static_cast<float*>(a.out_lo), a.hq, a.hkv, a.seq, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ, int BKV>
int attrs_f32(Attrs* out) {
  out->smem_bytes = F32Tile<BQ, BKV, D>::kBytes;
  return static_cast<int>(cudaFuncGetAttributes(&out->func, flash_f32_kernel<BQ, BKV, D>));
}

// The compiled (block_q, block_kv) tiles of each input type, which
// kernels/attention/kernel.py lists (TILES) and ops.py orders by their time
// on the card: F<D, BQ, BKV>(arg) for f32, W<D, BKV>(arg) for bf16.
#define F32_TILES(F, D, BQ_, BKV_, ARG)                      \
  switch ((BQ_) * 1000 + (BKV_)) {                           \
    case 32032: return F<D, 32, 32>(ARG);                    \
    case 64032: return F<D, 64, 32>(ARG);                    \
    case 64064: return F<D, 64, 64>(ARG);                    \
    case 128064: return F<D, 128, 64>(ARG);                  \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
#define BF16_TILES(W, D, BQ_, BKV_, ARG)                                   \
  if ((BQ_) != kBlockQ) return static_cast<int>(cudaErrorInvalidValue);    \
  switch (BKV_) {                                                          \
    case 64: return W<D, 64>(ARG);                                         \
    case 128:                                                              \
      if constexpr (kFwdTile<D, 128>) return W<D, 128>(ARG);               \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    default: return static_cast<int>(cudaErrorInvalidValue);               \
  }

template <typename T, int D>
int launch_d(int bq, int bkv, const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    BF16_TILES(launch_wgmma, D, bq, bkv, a)
  } else {
    if (a.seq % bq || a.seq % bkv) return static_cast<int>(cudaErrorInvalidValue);
    F32_TILES(launch_f32, D, bq, bkv, a)
  }
}

template <typename T, int D>
int attrs_d(int bq, int bkv, Attrs* out) {
  if constexpr (std::is_same<T, bf16>::value) {
    BF16_TILES(attrs_wgmma, D, bq, bkv, out)
  } else {
    F32_TILES(attrs_f32, D, bq, bkv, out)
  }
}

// the head dims of kernels/attention/kernel.py HEAD_DIMS
#define FWD_HEAD_DIMS(F, T, D_, ...)                          \
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
int launch_typed(int d, int bq, int bkv, const Args& a) {
  FWD_HEAD_DIMS(launch_d, T, d, bq, bkv, a)
}

template <typename T>
int attrs_typed(int d, int bq, int bkv, Attrs* out) {
  FWD_HEAD_DIMS(attrs_d, T, d, bq, bkv, out)
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  q, out: (batch, hq, seq, d); k, v: (batch, hkv,
// seq, d), all contiguous (bf16: 16-byte aligned, as TMA reads them).  bf16
// takes block_q 128 and any seq; f32 tiles must divide seq.  lse: null, or
// (batch, hq, seq) f32 that receives each row's log-sum-exp
// m + log(max(l, 1e-30)) of the scaled, masked logits, which the backward
// (flash_attention_bwd.cu) recomputes P from.  out_lo: null, or for bf16 a
// second (batch, hq, seq, d) bf16 output that receives bf16(o - out), o the
// f32 result, so that out + out_lo holds o to about 2^-16 of its value
// (ignored for f32, whose out is o).  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for arguments the kernels do
// not take, cudaErrorNotSupported where the driver has no
// cuTensorMapEncodeTiled, or 100000 + the CUresult where it refuses a
// tensor map.
int flash_attention_launch(int dtype, int d, int block_q, int block_kv, const void* q,
                           const void* k, const void* v, void* out, void* lse, void* out_lo,
                           int batch, int hq, int hkv, int seq, int causal, float scale,
                           void* stream) {
  if (batch < 1 || hkv < 1 || seq < 1 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
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
