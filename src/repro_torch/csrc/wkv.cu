// Chunked RWKV6 WKV recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_kernel` / `wkv_pallas` in
// src/repro/kernels/wkv/kernel.py.  Per (batch*head) and chunk of L steps,
// with Lambda the running sum of wlog over the chunk (Lambda_{-1} = 0) and S
// the state at the chunk's start:
//
//   out_t = sum_{s<t} (r_t . exp(Lambda_{t-1} - Lambda_s) . k_s) v_s
//         + (r_t . (u * k_t)) v_t
//         + (r_t * exp(Lambda_{t-1})) S
//   S    <- exp(Lambda_{L-1}) * S + sum_s (k_s * exp(Lambda_{L-1} - Lambda_s)) v_s^T
//
// Every exponent is <= 0 because wlog < 0, so nothing is factorized and
// nothing overflows.  The TPU kernel fills the masked entries (s >= t) of the
// decay tensor with exp(-60); here they are skipped (their share is below
// 1e-26 of a term), and the diagonal bonus is folded into A[t][t].
//
// Bound on the H100: device-memory bytes.  The function reads r, k, v and
// wlog once and writes out once: 20 bytes a (token, channel) against 6 K
// flops a token and head.  This design moves more (below): k, v and wlog are
// read twice, and the state at each chunk's start, K x K f32 per chunk of a
// row (4 K / L bytes a (token, channel)), is written once and read once:
// 64 bytes a (token, channel) at L = 16, K = 64, 48 at L = 32, 40 at L = 64.
// In training the states are an output anyway (csrc/wkv_bwd.cu reads them).
//
// Design: only the state recurrence is serial, so it runs alone, and the rest
// runs chunk-parallel.  Two kernels, launched one after the other on the
// caller's stream by one wkv_launch:
//
//   1. wkv_states_kernel, the state walk.  One block per (batch*head, 16 rows
//      i of the state): K / 16 warps, each owning a 16 x 16 tile of the
//      block's rows (its columns 16 w ..), walk the chunks in order.  Rows,
//      not columns: the rows are the key channels, so a block forms Lambda
//      and k' for its own 16 channels only, and each chunk-start state it
//      writes is 16 whole rows.  Per chunk:
//        - Lambda for 16 channels as a running sum down t;
//        - k' = k e^(Lambda_{L-1} - Lambda_s), formed once for the block,
//          straight into the tensor-core fragments of k'^T, split into tf32
//          hi and lo, in shared memory (each warp forms some k-steps);
//        - the injection k'^T v on mma.sync.m16n8k8 in 3xTF32 (tf32.cuh),
//          each warp its 16 columns;
//        - S_c written to `states`, then S <- e^(Lambda_{L-1}) S + k'^T v,
//          the state in registers, in the accumulator's layout.
//      Only the last step depends on the chunk before, so the walk is a
//      pipeline: chunk c + 1's fragments are formed while chunk c's products
//      and update run, one barrier a chunk.  k, wlog (the block's 16
//      channels) and v (all K) arrive by cp.async, kStages - 2 chunks ahead
//      of the fragments, each thread's copies addressed once before the
//      loop.  The walk computes no A, no r' and no out.
//   2. wkv_out_kernel, the outputs.  One block of 128 threads per
//      (chunk, batch*head); blocks are independent and read their S_c from
//      `states`.  Per chunk: Lambda by the same running sum (the same bits as
//      the walk's); A[t][s] over all K once, by 4 x 4 tiles of (t, s), K / 8
//      lanes a tile, 8 channels each, their sums reduced over the tile's
//      lanes (the diagonal tiles first; the warps past them take tiles
//      below the diagonal, where each decay splits at the tile's last step
//      into two factors <= 1, 7 exponentials a channel for 16 entries);
//      r' = r e^(Lambda_{t-1}) in place; out = A v + r' S on the tensor
//      cores in 3xTF32.  At most five blocks an SM, the registers bounded to
//      match.
//
// What limits it on the H100 (the port's PERF.md has the times, by kernel,
// from benchmarks/torch_wkv_turns.py, and the walk's cycles by phase from
// benchmarks/torch_wkv_phases.py): the walk, its chain of dependent
// instructions and copies a chunk at the few blocks of the models' shapes
// (two blocks an SM at RWKV6-1.6B's batch 2, four at batch 4); the outputs,
// the bytes and the issue of A's exponentials.
//
// The bonus u is one row of K for every row, or one per head (row
// bh % u_rows, the models' layout bh = b H + h); an initial state s0, where
// given, seeds the walk's registers (a prefill continuing a cached state).
// No atomics: two launches give the same bits.  Every exponential is of a
// difference <= 0 (exp_le0: ex2.approx of x log2(e)), whose error, though it
// grows with |x|, is scaled by the result.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

constexpr int kMaxSmemBytes = 232448;
constexpr int kRows = 16;  // rows i of the state a walk block owns
constexpr int kOutThreads = 128;
constexpr int kOutWarps = kOutThreads / 32;

// The walk's shared memory, in f32: kStages stages of a chunk each: k and
// wlog (the block's 16 channels, rows of RS) and v (all K, rows of VS); then
// two buffers of a chunk's tensor-core fragments of k'^T (tf32 hi and lo, 8
// words a lane for each k-step) and of its e^(Lambda_{L-1}) (16 rows).  RS =
// 24 and VS = K + 8 keep each warp's reads of a fragment on distinct banks.
template <int L, int K>
struct Walk {
  static constexpr int kWarps = K / 16;  // a 16 x 16 tile of the block's rows each
  static constexpr int kThreads = 32 * kWarps;
  // four stages at L = 16: the copies of chunk c + 2 start while chunk c's
  // fragments are formed; three at L = 32 and 64, so that four blocks (L = 32,
  // K = 64) and two (L = 64) fit an SM
  static constexpr int kStages = L == 16 ? 4 : 3;
  static constexpr int RS = 24;
  static constexpr int VS = K + 8;
  static constexpr int kStage = 2 * L * RS + L * VS;
  static constexpr int kSteps = L / 8;                             // k-steps of 8 steps s
  static constexpr int kStepsPerWarp = (kSteps + kWarps - 1) / kWarps;  // fragments each warp forms
  static constexpr int kFrag = kSteps * 32 * 8;                    // words of one buffer of fragments
  static constexpr int oFrag = kStages * kStage;
  static constexpr int oEl = oFrag + 2 * kFrag;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * (oEl + 2 * kRows);
  static constexpr int kCopies = L * (8 + K / 4) / kThreads;  // 16-byte copies a thread a stage
  static_assert(K % 16 == 0 && L % 8 == 0, "whole tiles");
  static_assert(L * (8 + K / 4) % kThreads == 0 && 8 * L % kThreads == 0,
                "whole copies a thread, each of one array");
  static_assert(kBytes <= kMaxSmemBytes, "stages exceed the shared memory of an H100 block");
};

// The output kernel's shared memory, in f32: r (then r'), k and wlog (then
// Lambda) in rows of RP = K + 4 (read as float4 along j, and r' as the
// tensor cores' A operand); v and S in rows of VP = K + 8 (their B operand);
// A in rows of AP = L + 4; u.
template <int L, int K>
struct Out {
  static constexpr int RP = K + 4, VP = K + 8, AP = L + 4;
  static constexpr int oR = 0, oK = oR + L * RP, oLam = oK + L * RP, oV = oLam + L * RP;
  static constexpr int oS = oV + L * VP, oA = oS + K * VP, oU = oA + L * AP;
  static constexpr int kFloats = oU + K;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * kFloats;
  static constexpr int kP = K / 8;  // lanes of one 4 x 4 tile of A, 8 channels each
  static constexpr int kTileRows = L / 4;
  static constexpr int kTiles = kTileRows * (kTileRows + 1) / 2;  // on or below the diagonal
  static constexpr int kTasks = kTiles * kP;
  static constexpr int kDiagTasks = kTileRows * kP;  // the diagonal tiles' lanes, first
  static constexpr int kCopies1 = 3 * L * K / 4;       // 16-byte copies of r, k, wlog
  static constexpr int kCopies2 = (L + K) * K / 4;     // of v and S_c
  // blocks an SM holds by shared memory (228 KB an SM, 1 KB of it reserved a
  // block), at most 5 (six, at 80 registers, spill A's sums at L = 16): the
  // registers are bounded to match
  static constexpr int kBySmem = 233472 / (kBytes + 1024);
  static constexpr int kMinBlocks = kBySmem < 1 ? 1 : kBySmem > 5 ? 5 : kBySmem;
  static_assert(32 % kP == 0 && L % 16 == 0 && K % 16 == 0, "whole tiles and lane groups");
  static_assert(kBytes <= kMaxSmemBytes, "chunk exceeds the shared memory of an H100 block");
};

__device__ __forceinline__ float lane_of(const float4& x, int f) {
  return f == 0 ? x.x : f == 1 ? x.y : f == 2 ? x.z : x.w;
}

// e^x for x <= 0: ex2.approx of x log2(e), results below 2^-126 flushed to
// 0.  Its error grows with |x| (the rounding of x log2(e)) but is scaled by
// the result: at most 2.2e-8 of the term it multiplies.
__device__ __forceinline__ float exp_le0(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The offset of the output kernel's chunk (blockIdx.x) of row blockIdx.y in
// a (bh, seq, K) array.  The block indices are read anew at each call, so
// the offset is formed again where it is used, not held in a register (or
// spilled) from the first copies to the last store.
template <int L, int K>
__device__ __forceinline__ int64_t chunk_offset(int seq) {
  uint32_t c, row;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(c));
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(row));
  return (static_cast<int64_t>(row) * seq + static_cast<int64_t>(c) * L) * K;
}

// two consecutive floats to global memory in one 8-byte store (a store
// through a float2 cast came out as two 4-byte stores here)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  asm volatile("st.global.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a), "f"(b));
}

// A chunk's k'^T fragments for k-step m (steps 8 m ... 8 m + 7), this
// lane's, split into tf32 hi and lo, into frag (8 words); with m = 0 also the
// chunk's e^(Lambda_{L-1}) of the block's 16 rows into el.  ks, wl: the
// chunk's k and wlog (L rows of RS).
template <int L, int K>
__device__ __forceinline__ void form_step(const float* ks, const float* wl, int m, int g, int q, uint32_t* frag,
                                          float* el) {
  constexpr int RS = Walk<L, K>::RS;
  // Lambda of channels g and g + 8 (the fragment's rows): a running sum down
  // t, as the output kernel forms it, noting Lambda at steps 8 m + q and
  // 8 m + q + 4
  float lam0 = 0.f, lam1 = 0.f, lq0[2], lq1[2];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    lam0 += wl[t * RS + g];
    lam1 += wl[t * RS + g + 8];
    if (t / 8 == m && (t & 3) == q) {
      lq0[t >> 2 & 1] = lam0;
      lq1[t >> 2 & 1] = lam1;
    }
  }
  const int s = 8 * m + q;
  const float a[4] = {ks[s * RS + g] * exp_le0(lam0 - lq0[0]), ks[s * RS + g + 8] * exp_le0(lam1 - lq1[0]),
                      ks[(s + 4) * RS + g] * exp_le0(lam0 - lq0[1]),
                      ks[(s + 4) * RS + g + 8] * exp_le0(lam1 - lq1[1])};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) split_tf32(a[x], hi[x], lo[x]);
  reinterpret_cast<uint4*>(frag)[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  reinterpret_cast<uint4*>(frag)[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  if (m == 0 && q == 0) {
    el[g] = exp_le0(lam0);
    el[g + 8] = exp_le0(lam1);
  }
}

template <int L, int K>
__global__ void __launch_bounds__(Walk<L, K>::kThreads)
    wkv_states_kernel(const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ wlog, const float* __restrict__ s0,
                      float* __restrict__ state_out, float* __restrict__ states, int seq) {
  using W = Walk<L, K>;
  constexpr int RS = W::RS, VS = W::VS, S = W::kStages, D = S - 1;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, i0 = blockIdx.y * kRows, e0 = 16 * warp;
  const int n_chunks = seq / L;
  const int64_t base = static_cast<int64_t>(bh) * seq * K;
  const int64_t kk = static_cast<int64_t>(K) * K;
  uint32_t* frags = reinterpret_cast<uint32_t*>(smem + W::oFrag);  // [2][kSteps][32][8]
  float* els = smem + W::oEl;                                     // [2][16]

  // this thread's copies of a stage: k and wlog rows (the block's 16
  // channels, four 16-byte pieces a row), then v rows (K / 4 pieces); where
  // each goes in the stage and where it comes from in the first chunk
  const float* src[W::kCopies];
  int dst[W::kCopies];
#pragma unroll
  for (int i = 0; i < W::kCopies; ++i) {
    const int x = tid + i * W::kThreads;
    if (i * W::kThreads < 8 * L) {
      const int a = x / (4 * L), t = x / 4 % L, c4 = x % 4;
      src[i] = (a ? wlog : k) + base + t * K + i0 + 4 * c4;
      dst[i] = (a * L + t) * RS + 4 * c4;
    } else {
      const int y = x - 8 * L, t = y / (K / 4), c4 = y % (K / 4);
      src[i] = v + base + t * K + 4 * c4;
      dst[i] = 2 * L * RS + t * VS + 4 * c4;
    }
  }
  auto issue = [&](int c) {  // chunk c into its stage, and commit
    if (c < n_chunks) {
      const int64_t off = static_cast<int64_t>(c) * L * K;
      float* st = smem + c % S * W::kStage;
#pragma unroll
      for (int i = 0; i < W::kCopies; ++i) cp_async16(st + dst[i], src[i] + off);
    }
    cp_async_commit();
  };
  // chunk c's fragments into buffer c & 1, this warp's k-steps of them: the
  // k' of the block's 16 rows, which every warp's product reads
  auto form = [&](int c) {
    const float* st = smem + c % S * W::kStage;
#pragma unroll
    for (int i = 0; i < W::kStepsPerWarp; ++i) {
      const int m = warp * W::kStepsPerWarp + i;
      if (W::kSteps % W::kWarps == 0 || m < W::kSteps)
        form_step<L, K>(st, st + L * RS, m, g, q, frags + (c & 1) * W::kFrag + (m * 32 + lane) * 8,
                        els + (c & 1) * kRows);
    }
  };

  // this lane's entries of the state: rows i0 + g (sreg[h][0, 1]) and
  // i0 + g + 8 (sreg[h][2, 3]), columns e0 + 8 h + 2 q + {0, 1}
  float sreg[NH][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i0 + g + (x >> 1) * 8, e = e0 + 8 * h + 2 * q + (x & 1);
      sreg[h][x] = s0 != nullptr ? s0[bh * kk + i * K + e] : 0.f;
    }
  float* sc = states + bh * n_chunks * kk + (i0 + g) * K + e0 + 2 * q;  // S_0 at this lane's first entry

  // A pipeline of chunks: chunk c + 1's fragments are formed while chunk c's
  // products and update run (only the update depends on the state), and D
  // chunks of copies are in flight ahead of chunk c
#pragma unroll
  for (int c = 0; c < D; ++c) issue(c);
  cp_async_wait<D - 1>();  // chunk 0 has landed
  __syncthreads();
  form(0);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<D - 2>();  // chunk c + 1 has landed
    __syncthreads();         // ... for every thread; chunk c's fragments are formed; chunk c - 1 is done
    issue(c + D);
    if (c + 1 < n_chunks) form(c + 1);
    // k'^T v: A(i, s) = k'[s][i] from the fragments, B(s, e) = v[s][e]
    const float* vs = smem + c % S * W::kStage + 2 * L * RS;
    const uint32_t* fb = frags + (c & 1) * W::kFrag;
    float inj[NH][4] = {};
#pragma unroll
    for (int m = 0; m < W::kSteps; ++m) {
      const uint4* f = reinterpret_cast<const uint4*>(fb + (m * 32 + lane) * 8);
      const uint4 h4 = f[0], l4 = f[1];
      const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w}, al[4] = {l4.x, l4.y, l4.z, l4.w};
      const int s = 8 * m + q;
      uint32_t bh[NH][2], bl[NH][2];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        split_tf32(vs[s * VS + e0 + 8 * h + g], bh[h][0], bl[h][0]);
        split_tf32(vs[(s + 4) * VS + e0 + 8 * h + g], bh[h][1], bl[h][1]);
      }
#pragma unroll
      for (int h = 0; h < NH; ++h) mma_tf32(inj[h], al, bh[h]);
#pragma unroll
      for (int h = 0; h < NH; ++h) mma_tf32(inj[h], ah, bl[h]);
#pragma unroll
      for (int h = 0; h < NH; ++h) mma_tf32(inj[h], ah, bh[h]);
    }
    // S_c, the state at the chunk's start; then S <- e^(Lambda_{L-1}) S + k'^T v, rounded once
    const float el0 = els[(c & 1) * kRows + g], el1 = els[(c & 1) * kRows + g + 8];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      store2(sc + 8 * h, sreg[h][0], sreg[h][1]);
      store2(sc + 8 * K + 8 * h, sreg[h][2], sreg[h][3]);
      sreg[h][0] = fmaf(el0, sreg[h][0], inj[h][0]);
      sreg[h][1] = fmaf(el0, sreg[h][1], inj[h][1]);
      sreg[h][2] = fmaf(el1, sreg[h][2], inj[h][2]);
      sreg[h][3] = fmaf(el1, sreg[h][3], inj[h][3]);
    }
    sc += kk;
  }

  float* so = state_out + bh * kk + (i0 + g) * K + e0 + 2 * q;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    store2(so + 8 * h, sreg[h][0], sreg[h][1]);
    store2(so + 8 * K + 8 * h, sreg[h][2], sreg[h][3]);
  }
}

// One 4 x 4 tile of A, (t0 ..., s0 ...), this lane's 8 channels j of it,
// into x.  A diagonal tile (kDiagonal) holds s >= t too, so each factor is
// selected: the decay below the diagonal, u on it, 0 above.  A tile below
// the diagonal (t0 >= s0 + 4) splits each decay at its last step p = s0 + 3:
// e^(Lambda_{t-1} - Lambda_s) = e^(Lambda_{t-1} - Lambda_p) e^(Lambda_p -
// Lambda_s), both exponents <= 0, so r_t and k_s each take their factor
// once: 7 exponentials a channel for the tile's 16 entries, not 16.
template <bool kDiagonal, int L, int K>
__device__ __forceinline__ void a_tile(float (&x)[16], const float* rs, const float* ks, const float* lam,
                                       const float* us, int t0, int s0, int p) {
  constexpr int RP = Out<L, K>::RP, kP = Out<L, K>::kP;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int j = 4 * p + 4 * kP * m;
    float4 ls[4], kv[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      ls[y] = *reinterpret_cast<const float4*>(lam + (s0 + y) * RP + j);
      kv[y] = *reinterpret_cast<const float4*>(ks + (s0 + y) * RP + j);
    }
    const float4 u4 = *reinterpret_cast<const float4*>(us + j);
    float kq[4][4];  // below the diagonal: k_s e^(Lambda_p - Lambda_s)
    if (!kDiagonal)
#pragma unroll
      for (int sb = 0; sb < 4; ++sb)
#pragma unroll
        for (int f = 0; f < 4; ++f)
          kq[sb][f] = sb == 3 ? lane_of(kv[3], f)
                              : lane_of(kv[sb], f) * exp_le0(lane_of(ls[3], f) - lane_of(ls[sb], f));
#pragma unroll
    for (int ta = 0; ta < 4; ++ta) {
      const int t = t0 + ta;
      const float4 rt = *reinterpret_cast<const float4*>(rs + t * RP + j);
      const float4 lp = *reinterpret_cast<const float4*>(lam + max(t - 1, 0) * RP + j);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (kDiagonal) {
#pragma unroll
          for (int sb = 0; sb < 4; ++sb) {
            const int s = s0 + sb;
            float w = exp_le0(lane_of(lp, f) - lane_of(ls[sb], f));
            w = s < t ? w : (s == t ? lane_of(u4, f) : 0.f);
            x[ta * 4 + sb] = fmaf(lane_of(rt, f) * w, lane_of(kv[sb], f), x[ta * 4 + sb]);
          }
        } else {
          const float rp = lane_of(rt, f) * exp_le0(lane_of(lp, f) - lane_of(ls[3], f));
#pragma unroll
          for (int sb = 0; sb < 4; ++sb) x[ta * 4 + sb] = fmaf(rp, kq[sb][f], x[ta * 4 + sb]);
        }
      }
    }
  }
}

template <int L, int K>
__global__ void __launch_bounds__(kOutThreads, Out<L, K>::kMinBlocks)
    wkv_out_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ wlog,
                   const float* __restrict__ u, int u_rows, const float* __restrict__ states,
                   float* __restrict__ out, int seq) {
  using O = Out<L, K>;
  constexpr int RP = O::RP, VP = O::VP, AP = O::AP, KQ = K / 4;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem + O::oR;    // [L][RP]: r, then r' = r e^(Lambda_{t-1})
  float* ks = smem + O::oK;    // [L][RP]
  float* lam = smem + O::oLam;  // [L][RP]: wlog, then Lambda
  float* vs = smem + O::oV;    // [L][VP]
  float* ss = smem + O::oS;    // [K][VP]: S_c
  float* a = smem + O::oA;     // [L][AP]: A, 0 above the diagonal
  float* us = smem + O::oU;    // [K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int n_chunks = seq / L;
  const int64_t off = chunk_offset<L, K>(seq);
  const float* sc = states + (static_cast<int64_t>(bh) * n_chunks + c) * K * K;

  // two groups of copies: r, k, wlog first, then v and S_c
#pragma unroll
  for (int i = 0; i < (O::kCopies1 + kOutThreads - 1) / kOutThreads; ++i) {
    const int x = tid + i * kOutThreads;
    const int arr = x / (L * KQ), t = x / KQ % L, c4 = x % KQ;
    if (O::kCopies1 % kOutThreads == 0 || x < O::kCopies1)
      cp_async16(smem + (arr * L + t) * RP + 4 * c4, (arr == 0 ? r : arr == 1 ? k : wlog) + off + t * K + 4 * c4);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < (O::kCopies2 + kOutThreads - 1) / kOutThreads; ++i) {
    const int x = tid + i * kOutThreads;
    const int row = x / KQ, c4 = x % KQ;
    if (O::kCopies2 % kOutThreads == 0 || x < O::kCopies2) {
      if (row < L)
        cp_async16(vs + row * VP + 4 * c4, v + off + row * K + 4 * c4);
      else
        cp_async16(ss + (row - L) * VP + 4 * c4, sc + (row - L) * K + 4 * c4);
    }
  }
  cp_async_commit();
  for (int x = tid; x < L * AP; x += kOutThreads) a[x] = 0.f;
  for (int x = tid; x < K; x += kOutThreads) us[x] = u[(bh % u_rows) * K + x];
  cp_async_wait<1>();  // r, k, wlog
  __syncthreads();

  // 1. Lambda: a running sum down t, one thread a channel, the walk's order
  if (tid < K) {
    float x = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      x += lam[t * RP + tid];
      lam[t * RP + tid] = x;
    }
  }
  __syncthreads();

  // 2. A[t][s]: decayed r.k for s < t, the bonus r.(u*k) on s = t, by 4 x 4
  // tiles of (t, s) on or below the diagonal, the diagonal ones first.  kP
  // lanes share a tile, lane p taking channels 4 p + 4 kP m + {0..3}, m = 0,
  // 1, read as float4 (the kP lanes of a tile read one contiguous row
  // segment); each lane sums its channels for all 16 entries, and a
  // reduce-scatter over the tile's lanes leaves 16 / kP entries on each.
  for (int b0 = warp * 32; b0 < O::kTasks; b0 += kOutThreads) {
    const int task = b0 + lane, p = lane % O::kP;
    const bool valid = task < O::kTasks;
    const int tile = valid ? task / O::kP : 0;
    int T, S;
    if (tile < O::kTileRows) {
      T = S = tile;
    } else {  // (1, 0), (2, 0), (2, 1), (3, 0), ...
      T = 1;
      S = tile - O::kTileRows;
      while (S >= T) S -= T++;
    }
    float x[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = 0.f;
    if (b0 >= O::kDiagTasks)
      a_tile<false, L, K>(x, rs, ks, lam, us, 4 * T, 4 * S, p);
    else  // a warp that holds a diagonal tile takes every tile as one
      a_tile<true, L, K>(x, rs, ks, lam, us, 4 * T, 4 * S, p);
    reduce_scatter<16, O::kP>(x, p);
    if (valid)
#pragma unroll
      for (int e = 0; e < 16 / O::kP; ++e) {
        const int at = p * (16 / O::kP) + e;
        a[(4 * T + at / 4) * AP + 4 * S + at % 4] = x[e];
      }
  }
  __syncthreads();

  // 3. r' = r e^(Lambda_{t-1}) in place (A has read r)
  for (int x = tid + K; x < L * K; x += kOutThreads) {
    const int t = x / K, j = x % K;
    rs[t * RP + j] *= exp_le0(lam[(t - 1) * RP + j]);
  }
  cp_async_wait<0>();  // v and S_c
  __syncthreads();

  // 4. out = A v + r' S_c on the tensor cores, one 16 x 16 tile a warp at a time
  for (int n = warp; n < (L / 16) * (K / 16); n += kOutWarps) {
    const int M = n / (K / 16), N = n % (K / 16);
    float acc[NH][4] = {};
    mma_tile<L>(acc, [&](int t, int s) { return a[(16 * M + t) * AP + s]; },
                [&](int s, int e) { return vs[s * VP + 16 * N + e]; }, lane);
    mma_tile<K>(acc, [&](int t, int j) { return rs[(16 * M + t) * RP + j]; },
                [&](int j, int e) { return ss[j * VP + 16 * N + e]; }, lane);
    const int g = lane >> 2, q = lane & 3;
    float* o = out + chunk_offset<L, K>(seq) + (16 * M + g) * K + 16 * N + 2 * q;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      store2(o + 8 * h, acc[h][0], acc[h][1]);
      store2(o + 8 * K + 8 * h, acc[h][2], acc[h][3]);
    }
  }
}

struct Args {
  const float *r, *k, *v, *wlog, *u;
  int u_rows;
  const float* s0;
  float *out, *state, *states;
  int bh, seq;
  cudaStream_t stream;
};

template <class F>
int allow_smem(F kernel, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();  // do not leave the error for the next launch's check
  return static_cast<int>(err);
}

template <int L, int K>
int launch_chunk(const Args& a) {
  using W = Walk<L, K>;
  using O = Out<L, K>;
  int err = allow_smem(wkv_states_kernel<L, K>, W::kBytes);
  if (err == 0) err = allow_smem(wkv_out_kernel<L, K>, O::kBytes);
  if (err != 0) return err;
  wkv_states_kernel<L, K><<<dim3(a.bh, K / kRows), W::kThreads, W::kBytes, a.stream>>>(
      a.k, a.v, a.wlog, a.s0, a.state, a.states, a.seq);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || a.seq == 0) return err;
  wkv_out_kernel<L, K><<<dim3(a.seq / L, a.bh), kOutThreads, O::kBytes, a.stream>>>(
      a.r, a.k, a.v, a.wlog, a.u, a.u_rows, a.states, a.out, a.seq);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 the state walk, 1 the output kernel
template <int L, int K>
int attrs_chunk(int which, cudaFuncAttributes* out, int* smem_bytes) {
  *smem_bytes = which == 0 ? Walk<L, K>::kBytes : Out<L, K>::kBytes;
  return static_cast<int>(which == 0 ? cudaFuncGetAttributes(out, wkv_states_kernel<L, K>)
                                     : cudaFuncGetAttributes(out, wkv_out_kernel<L, K>));
}

// Calls F<L, K>(args...) for the compiled (chunk, K) pairs.
#define WKV_CHUNKS(F, L_, K_, ...)                           \
  switch ((L_) * 1000 + (K_)) {                              \
    case 16016: return F<16, 16>(__VA_ARGS__);               \
    case 16032: return F<16, 32>(__VA_ARGS__);               \
    case 16064: return F<16, 64>(__VA_ARGS__);               \
    case 32016: return F<32, 16>(__VA_ARGS__);               \
    case 32032: return F<32, 32>(__VA_ARGS__);               \
    case 32064: return F<32, 64>(__VA_ARGS__);               \
    case 64016: return F<64, 16>(__VA_ARGS__);               \
    case 64032: return F<64, 32>(__VA_ARGS__);               \
    case 64064: return F<64, 64>(__VA_ARGS__);               \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

extern "C" {

// r, k, v, wlog, out: (bh, seq, K) f32; u: (u_rows, K), row bh % u_rows
// for row bh of the others (u_rows = 1: one u for all; u_rows = H with
// bh = b H + h: one per head); s0: (bh, K, K), the initial state, or null
// for zeros; state: (bh, K, K), the final state; states: (bh, seq / chunk,
// K, K), the state at each chunk's start (s0 or zeros at the first), never
// null: the output kernel reads them (a caller that does not keep them
// passes scratch).  Launches the state walk, then the output kernel, on
// `stream`.  Returns cudaGetLastError() after the launches (0 on success);
// argument errors return cudaErrorInvalidValue.
int wkv_launch(int chunk, int K, const float* r, const float* k, const float* v,
               const float* wlog, const float* u, int u_rows, const float* s0, float* out,
               float* state, float* states, int bh, int seq, void* stream) {
  if (bh < 1 || chunk < 1 || seq % chunk || u_rows < 1 || bh % u_rows || states == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, wlog, u, u_rows, s0, out, state, states, bh, seq,
               static_cast<cudaStream_t>(stream)};
  WKV_CHUNKS(launch_chunk, chunk, K, a)
}

// Registers and local (spill) bytes per thread, the largest block, and the
// dynamic shared memory of the compiled instantiation of the state walk
// (which = 0) or of the output kernel (which = 1).
int wkv_attributes(int chunk, int K, int which, int* regs, int* local_bytes, int* max_threads,
                   int* smem_bytes) {
  if (which != 0 && which != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const int err = [&]() -> int { WKV_CHUNKS(attrs_chunk, chunk, K, which, &a, smem_bytes) }();
  if (err != 0) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
