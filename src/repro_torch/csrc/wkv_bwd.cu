// Gradient of the chunked RWKV6 WKV recurrence, for Hopper (sm_90a).
//
// The Pallas TPU kernel `wkv_pallas` (src/repro/kernels/wkv/kernel.py) has
// no backward: the JAX package differentiates its scan, `_wkv_scan` in
// src/repro/models/rwkv6.py.  This kernel computes that gradient in the
// chunked form of csrc/wkv.cu, the chunks in reverse, carrying G, the
// gradient of the state at the chunk's end.  Per (batch*head) and chunk of
// L steps, with Lambda the running sum of wlog over the chunk (Lambda_{-1} =
// 0), S the state at the chunk's start (saved by the forward), D[t][s] =
// e^(Lambda_{t-1} - Lambda_s) for s < t, A[t][s] = sum_i r_t D[t][s] k_s,
// b_t = r_t . (u * k_t) and delta_ts = dO_t . v_s:
//
//   dv_s  = sum_{t>s} A[t][s] dO_t + b_s dO_s + (k_s e^(Lambda_{L-1} - Lambda_s)) G
//   dr~_t = sum_{s<t} D[t][s] k_s delta_ts + e^(Lambda_{t-1}) (S dO_t)
//   dk~_s = sum_{t>s} r_t D[t][s] delta_ts + e^(Lambda_{L-1} - Lambda_s) (G v_s)
//   dr_t  = dr~_t + u k_t delta_tt ;  dk_s = dk~_s + r_s u delta_ss ;  du += r_t k_t delta_tt
//   dwlog_tau = e^(Lambda_{L-1}) sum_j G_ij S_ij
//             + sum_{s<tau} k_s e^(Lambda_{L-1} - Lambda_s) (G v_s)
//             + sum_{t>tau} r_t e^(Lambda_{t-1}) (S dO_t)
//             + sum_{s<tau<t} r_t D[t][s] k_s delta_ts
//   G <- e^(Lambda_{L-1}) G + sum_t (r_t e^(Lambda_{t-1})) dO_t^T
//
// and ds0 is G after the first chunk.  dwlog_tau is the state's gradient
// after step tau times e^(wlog_tau) times the state before it, split at the
// chunk's start and at tau: each term carries the decay of step tau, so a
// channel that forgets fast has a small dwlog computed from small terms.  (The
// same sum as reverse cumsums of dLambda cancels there.)  Every exponent is a
// difference that is <= 0 (wlog <= 0), as in the forward; e^(-Lambda) alone
// is never formed.  kernels/wkv/ref.py's wkv_bwd_plain is the same
// computation in PyTorch.
//
// Bound on the H100: device-memory bytes (36 B a (token, channel) read and
// written, and the chunk-start states); the kernel is far from it, held back
// by its instructions and by the few warps a chunk's dependent phases keep
// busy (the port's PERF.md has its times and its cycles by phase, from
// benchmarks/torch_wkv_bwd_phases.py).  What the design does about it:
//
// One block of 256 threads per (batch*head, 16 rows i of the state).  Every
// term above is separable in i (the key channel) except dv, which sums over
// i: so each block owns rows i0 .. i0 + 15 of G and computes dr, dk, dwlog
// and du for its 16 channels completely, and its share of dv over them.
// With K / 16 blocks a row, the shares go to a scratch (split, BH, S, K) and
// a second kernel sums them in the order of the splits: no atomics, the same
// bits every run.  At K = 16 the one share is dv itself.  (Summing the
// shares in a thread-block cluster's shared memory instead was slower on the
// H100, the port's PERF.md has both times: fewer clusters than blocks fit at
// once, and the receive buffers cost the fourth block an SM.)
//
// The six products that carry no decay run on the tensor cores,
// mma.sync.m16n8k8 in TF32 with f32 accumulation, each operand split into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi) and accumulated as x_lo y_hi +
// x_hi y_lo + x_hi y_hi ("3xTF32"; one TF32 rounding alone is 4.9e-4 of
// relative error, the size of the rule the gradients are held to):
// delta = dO v^T, S dO^T, G v^T, dv's share [A^T | k'^T] [dO ; G] and G's
// update r'^T dO.  Each decay D[t][s] is computed once, by the thread of
// (t, i), and every sum that reads it is taken from that one value.  Lambda
// is a running sum down t, as in the plain version: its rounding up to s is
// shared by every Lambda_t after it and cancels in their differences (a
// tree scan's does not, and it doubled the error of dr, dk and dwlog on
// RWKV6-1.6B's first layer).  Four blocks fit an SM, so the 512 blocks of
// RWKV6-1.6B's training shape run as one wave on 132 SMs.  Per chunk, with
// barriers between:
//   1. wait for the chunk's copies; issue the next chunk's r, k, wlog, dO
//      (cp.async, two stages);
//   2. Lambda (16 lanes, one a channel; k channel-major); sum_j G_ij S_ij;
//      delta, S dO^T, G v^T on the tensor cores in 16 x 16 tiles, one a
//      warp; then issue the next v and S;
//   3. per 16 x 16 block (t, s), s <= t: the thread of (t, i) forms D[t][s]
//      for its 16 s (__expf of a difference <= 0), sums dr~ (and the prefix
//      that the cross term needs) in registers, and its shares of dk~_s and
//      of the cross term are summed over t by a shuffle reduce-scatter across
//      the 16 lanes of t; its shares of A over its channel pair go to shared
//      memory, and after a barrier A is summed over the 8 pairs;
//   4. per (t, i): dr, dk, r', k', du, and dwlog by shuffle scans down and
//      up t, written over S dO^T, G v^T and the cross term;
//   5. dv's share and G's update on the tensor cores; dr, dk, dwlog out.
//
// Shared memory, in f32: two stages of r, k, wlog (L x 20 each) and dO
// (L x (K+4)); v (L x (K+4)), S's rows (16 x (K+4)); G, twice (16 x (K+4));
// delta, then A (L x (L+4)); Lambda, k, S dO^T, G v^T, r', dk~, the cross
// term (16 x (L+4) each, channel-major); k' (L x 20); A's partial sums, one
// or two buffers of 8 x 16 x 20.  55.7 KB at L = 16, K = 64, so four blocks
// an SM (the registers bounded to 64 to match); 169.7 KB at L = K = 64.
// Dynamic shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // rows i of the state per block
constexpr int kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

template <int L, int K>
struct Bwd {
  static constexpr int kSplit = K / kRows;  // blocks of a row
  static constexpr int kTB = L / 16;        // 16-step blocks of the chunk
  static constexpr int kSub = kTB * (kTB + 1) / 2;  // blocks (t, s) with s <= t
  static constexpr int kYBufs = kSub > 1 ? 2 : 1;
  static constexpr int KP = K + 4;  // row of an (., K) array
  static constexpr int RP = 20;     // row of an (., 16) array
  static constexpr int CP = L + 4;  // row of a channel-major (16, L) array
  static constexpr int AP = L + 4;  // row of delta, then A
  static constexpr int kRKW = 3 * L * RP;  // r, k, wlog of one stage
  static constexpr int kDO = L * KP;
  static constexpr int kYBuf = kWarps * 16 * RP;
  // offsets in floats, each a multiple of 4
  static constexpr int oRKW = 0;
  static constexpr int oDO = oRKW + 2 * kRKW;
  static constexpr int oV = oDO + 2 * kDO;
  static constexpr int oS = oV + L * KP;
  static constexpr int oG = oS + kRows * KP;
  static constexpr int oA = oG + 2 * kRows * KP;
  static constexpr int oLam = oA + L * AP;
  static constexpr int oKT = oLam + kRows * CP;
  static constexpr int oSD = oKT + kRows * CP;
  static constexpr int oGV = oSD + kRows * CP;
  static constexpr int oRP = oGV + kRows * CP;
  static constexpr int oDK = oRP + kRows * CP;
  static constexpr int oCross = oDK + kRows * CP;
  static constexpr int oKP = oCross + kRows * CP;
  static constexpr int oY = oKP + L * RP;
  static constexpr int oU = oY + kYBufs * kYBuf;
  static constexpr int oGS = oU + kRows;
  static constexpr int oEL = oGS + kRows;
  static constexpr int kFloats = oEL + kRows;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * kFloats;
  // blocks an SM holds by shared memory (228 KB an SM, 1 KB of it reserved
  // a block), at most 4 at K = 64 and 3 below (at 64 registers K = 16 and 32
  // spill): the registers are bounded to match
  static constexpr int kBySmem = 233472 / (kBytes + 1024);
  static constexpr int kMaxBlocks = K == 64 ? 4 : 3;
  static constexpr int kMinBlocks = kBySmem < 1 ? 1 : kBySmem > kMaxBlocks ? kMaxBlocks : kBySmem;
  static_assert(K % kRows == 0 && L % 16 == 0, "whole 16-row splits");
  static_assert(kBytes <= kMaxSmemBytes, "chunk exceeds the shared memory of an H100 block");
};

// r, k, wlog (the block's 16 channels) and dO (all K) of one chunk
template <int L, int K>
__device__ __forceinline__ void load_rkwo(float* rkw, float* dos, const float* r, const float* k,
                                          const float* wlog, const float* dout, int64_t off, int i0,
                                          int tid) {
  using B = Bwd<L, K>;
  for (int x = tid; x < 3 * L * 4; x += kThreads) {
    const int a = x / (4 * L), t = x / 4 % L, q = x % 4;
    const float* src = a == 0 ? r : a == 1 ? k : wlog;
    cp_async16(rkw + a * L * B::RP + t * B::RP + 4 * q, src + off + t * K + i0 + 4 * q);
  }
  for (int x = tid; x < L * K / 4; x += kThreads) {
    const int t = x / (K / 4), q = x % (K / 4);
    cp_async16(dos + t * B::KP + 4 * q, dout + off + t * K + 4 * q);
  }
}

// v (all K) and the block's 16 rows of the chunk-start state
template <int L, int K>
__device__ __forceinline__ void load_vs(float* vs, float* st, const float* v, const float* sg,
                                        int64_t off, int i0, int tid) {
  using B = Bwd<L, K>;
  for (int x = tid; x < (L + kRows) * K / 4; x += kThreads) {
    const int t = x / (K / 4), q = x % (K / 4);
    if (t < L)
      cp_async16(vs + t * B::KP + 4 * q, v + off + t * K + 4 * q);
    else
      cp_async16(st + (t - L) * B::KP + 4 * q, sg + (i0 + t - L) * K + 4 * q);
  }
}

template <int L, int K>
__global__ void __launch_bounds__(kThreads, Bwd<L, K>::kMinBlocks)
    wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ wlog,
                   const float* __restrict__ u, int u_rows, const float* __restrict__ dout,
                   const float* __restrict__ ds, const float* __restrict__ states,
                   float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ shares,
                   float* __restrict__ dwlog, float* __restrict__ du_rows,
                   float* __restrict__ ds0, int seq) {
  using B = Bwd<L, K>;
  constexpr int KP = B::KP, RP = B::RP, CP = B::CP, AP = B::AP, TB = B::kTB;
  extern __shared__ __align__(16) float smem[];
  float* vs = smem + B::oV;         // [L][KP]
  float* st = smem + B::oS;         // [16][KP]: S, the block's rows
  float* ad = smem + B::oA;         // [L][AP]: delta on and below the diagonal blocks, then A
  float* lam = smem + B::oLam;      // [16][CP]: Lambda
  float* kt = smem + B::oKT;        // [16][CP]: k, channel-major
  float* sdo = smem + B::oSD;       // [16][CP]: S dO^T, then dr
  float* gvs = smem + B::oGV;       // [16][CP]: G v^T, then dk
  float* rp = smem + B::oRP;        // [16][CP]: r e^(Lambda_{t-1})
  float* dks = smem + B::oDK;       // [16][CP]: dk~'s decayed sum
  float* cross = smem + B::oCross;  // [16][CP]: dwlog's sum over s < tau < t, then dwlog
  float* kp = smem + B::oKP;        // [L][RP]: k e^(Lambda_{L-1} - Lambda_t)
  float* us = smem + B::oU;         // [16]
  float* gs = smem + B::oGS;        // [16]: sum_j G_ij S_ij
  float* elast = smem + B::oEL;     // [16]: e^(Lambda_{L-1})

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, i0 = blockIdx.y * kRows;
  // steps 3 and 4: lane (c2, tq) of warp w is channel 2w + c2, step tq of a 16-step block
  const int c2 = lane >> 4, tq = lane & 15, ii = 2 * warp + c2;
  const int n_chunks = seq / L;
  const int64_t base = static_cast<int64_t>(bh) * seq * K;
  const int64_t kk = static_cast<int64_t>(K) * K;
  const float* sg_row = states + static_cast<int64_t>(bh) * n_chunks * kk;

  if (tid < kRows) us[tid] = u[(bh % u_rows) * K + i0 + tid];
  for (int x = tid; x < kRows * K; x += kThreads) {
    const int i = x / K, j = x % K;
    smem[B::oG + i * KP + j] = ds != nullptr ? ds[bh * kk + (i0 + i) * K + j] : 0.f;
  }
  for (int x = tid; x < L * AP; x += kThreads) ad[x] = 0.f;  // A is 0 above the diagonal blocks
  float du_acc = 0.f;  // channel ii, over this lane's steps

  {
    const int64_t off = base + static_cast<int64_t>(n_chunks - 1) * L * K;
    load_rkwo<L, K>(smem + B::oRKW, smem + B::oDO, r, k, wlog, dout, off, i0, tid);
    load_vs<L, K>(vs, st, v, sg_row + (n_chunks - 1) * kk, off, i0, tid);
    cp_async_commit();
  }

  for (int it = 0; it < n_chunks; ++it) {
    const int c = n_chunks - 1 - it, cur = it & 1;
    const int64_t off = base + static_cast<int64_t>(c) * L * K;
    const float* rs = smem + B::oRKW + cur * B::kRKW;  // [L][RP]
    const float* ks = rs + L * RP;
    const float* wl = ks + L * RP;
    const float* dos = smem + B::oDO + cur * B::kDO;   // [L][KP]
    const float* gcur = smem + B::oG + cur * kRows * KP;
    float* gnext = smem + B::oG + (cur ^ 1) * kRows * KP;

    // 1. this chunk's copies; the next chunk's r, k, wlog, dO
    cp_async_wait_all();
    __syncthreads();
    if (c > 0) {
      const int64_t nxt = off - static_cast<int64_t>(L) * K;
      load_rkwo<L, K>(smem + B::oRKW + (cur ^ 1) * B::kRKW, smem + B::oDO + (cur ^ 1) * B::kDO, r, k,
                      wlog, dout, nxt, i0, tid);
      cp_async_commit();
    }

    // 2. Lambda, sum_j G S, and the products without decay
    if (tq == 0) {  // a running sum down t, as in the plain version: the rounding of
      float x = 0.f;  // Lambda_s is shared by every Lambda_t after it, and cancels in their differences
      for (int t = 0; t < L; ++t) {
        x += wl[t * RP + ii];
        lam[ii * CP + t] = x;
      }
    }
#pragma unroll
    for (int T = 0; T < TB; ++T) kt[ii * CP + 16 * T + tq] = ks[(16 * T + tq) * RP + ii];
    {
      const int i = tid >> 4, q = tid & 15;
      float acc = 0.f;
#pragma unroll
      for (int j = q * (K / 16); j < (q + 1) * (K / 16); ++j) acc = fmaf(gcur[i * KP + j], st[i * KP + j], acc);
#pragma unroll
      for (int d = 8; d >= 1; d /= 2) acc += __shfl_xor_sync(kFull, acc, d);
      if (q == 0) gs[i] = acc;
    }
    for (int tile = warp; tile < B::kSub + 2 * TB; tile += kWarps) {  // 16 x 16 tiles
      float acc[2][4] = {};
      if (tile < B::kSub) {  // delta[t][s] = dO_t . v_s, block (M, N), N <= M
        int M = 0, N = tile;
        while (N > M) N -= ++M;
        mma_tile<K>(acc, [&](int m, int j) { return dos[(16 * M + m) * KP + j]; },
                    [&](int j, int s) { return vs[(16 * N + s) * KP + j]; }, lane);
        tile_out(acc, lane, [&](int t, int s, float x) { ad[(16 * M + t) * AP + 16 * N + s] = x; });
      } else if (tile < B::kSub + TB) {  // (S dO^T)[i][t]
        const int N = tile - B::kSub;
        mma_tile<K>(acc, [&](int i, int j) { return st[i * KP + j]; },
                    [&](int j, int t) { return dos[(16 * N + t) * KP + j]; }, lane);
        tile_out(acc, lane, [&](int i, int t, float x) { sdo[i * CP + 16 * N + t] = x; });
      } else {  // (G v^T)[i][t]
        const int N = tile - B::kSub - TB;
        mma_tile<K>(acc, [&](int i, int j) { return gcur[i * KP + j]; },
                    [&](int j, int t) { return vs[(16 * N + t) * KP + j]; }, lane);
        tile_out(acc, lane, [&](int i, int t, float x) { gvs[i * CP + 16 * N + t] = x; });
      }
    }
    __syncthreads();
    if (c > 0) {
      const int64_t nxt = off - static_cast<int64_t>(L) * K;
      load_vs<L, K>(vs, st, v, sg_row + (c - 1) * kk, nxt, i0, tid);
      cp_async_commit();
    }

    // 3. the decays, block (T, S) of (t, s) at a time
    float dr_reg[TB], dtt[TB];
    {
      const float uu = us[ii];
      int n = 0;
#pragma unroll
      for (int T = 0; T < TB; ++T) {
        const int t = 16 * T + tq;
        const float rt = rs[t * RP + ii], rtu = rt * uu;
        const float lp = t > 0 ? lam[ii * CP + t - 1] : 0.f;
        dtt[T] = ad[t * AP + t];
        float q = 0.f;  // sum_{s' < s} D[t][s'] delta_ts' k_s'
#pragma unroll 1
        for (int S = 0; S <= T; ++S, ++n) {
          float* yp = smem + B::oY + (n % B::kYBufs) * B::kYBuf;  // [8][16][RP]: A's sums over a channel pair
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x[8], w[8], y[8];
#pragma unroll
            for (int e4 = 0; e4 < 8; e4 += 4) {
              const int s0 = 16 * S + 8 * h + e4;
              const float4 l4 = *reinterpret_cast<const float4*>(lam + ii * CP + s0);
              const float4 k4 = *reinterpret_cast<const float4*>(kt + ii * CP + s0);
              const float4 d4 = *reinterpret_cast<const float4*>(ad + t * AP + s0);
              const float la[4] = {l4.x, l4.y, l4.z, l4.w}, ka[4] = {k4.x, k4.y, k4.z, k4.w},
                          da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                const int e = e4 + f, sl = 8 * h + e;
                const bool below = S < T || sl < tq;
                const float d = below ? __expf(lp - la[f]) : 0.f;  // D[t][s]
                const float rd = rt * d;
                w[e] = below ? rt * q : 0.f;  // r_t sum_{s' < s} ...: the cross term's share at tau = s
                q = fmaf(d * da[f], ka[f], q);
                x[e] = rd * da[f];                                       // dk~_s's share
                y[e] = S == T && sl == tq ? rtu * ka[f] : rd * ka[f];  // A[t][s]'s, b_t on the diagonal
              }
            }
            reduce_scatter<8, 16>(x, tq);
            reduce_scatter<8, 16>(w, tq);
            float keep[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float send = c2 ? y[e] : y[4 + e];
              keep[e] = (c2 ? y[4 + e] : y[e]) + __shfl_xor_sync(kFull, send, 16);
            }
            *reinterpret_cast<float4*>(yp + (warp * 16 + tq) * RP + 8 * h + 4 * c2) =
                make_float4(keep[0], keep[1], keep[2], keep[3]);
            if (!(tq & 1)) {  // lanes tq and tq + 1 hold the sums for s = 16 S + 8 h + tq / 2
              const int at = ii * CP + 16 * S + 8 * h + (tq >> 1);
              dks[at] = S == T ? x[0] : dks[at] + x[0];
              cross[at] = S == T ? w[0] : cross[at] + w[0];
            }
          }
          if (S == T) dr_reg[T] = q;
          __syncthreads();
          {  // A over the 8 channel pairs
            const int at = tid >> 4, as = tid & 15;
            float acc = yp[at * RP + as];
#pragma unroll
            for (int w2 = 1; w2 < kWarps; ++w2) acc += yp[(w2 * 16 + at) * RP + as];
            ad[(16 * T + at) * AP + 16 * S + as] = acc;
          }
        }
      }
    }
    __syncwarp();

    // 4. per (t, i): dr, dk, r', k', du; dwlog by scans down and up t
    {
      const float uu = us[ii];
      const float llast = lam[ii * CP + L - 1];
      const float el_last = expf(llast);
      const float start = el_last * gs[ii];
      if (tq == 0) elast[ii] = el_last;
      float rsd[TB], kgv[TB];
#pragma unroll
      for (int T = 0; T < TB; ++T) {
        const int t = 16 * T + tq;
        const float lt = lam[ii * CP + t];
        const float el = t > 0 ? expf(lam[ii * CP + t - 1]) : 1.f;  // e^(Lambda_{t-1})
        const float tl = expf(llast - lt);                           // e^(Lambda_{L-1} - Lambda_t)
        const float rt = rs[t * RP + ii], kt = ks[t * RP + ii];
        const float sd = sdo[ii * CP + t], gv = gvs[ii * CP + t];
        const float drt = fmaf(el, sd, dr_reg[T]);
        const float dkt = fmaf(tl, gv, dks[ii * CP + t]);
        sdo[ii * CP + t] = fmaf(uu * kt, dtt[T], drt);
        gvs[ii * CP + t] = fmaf(rt * uu, dtt[T], dkt);
        du_acc = fmaf(rt * kt, dtt[T], du_acc);
        rp[ii * CP + t] = rt * el;
        kp[t * RP + ii] = kt * tl;
        rsd[T] = rt * el * sd;
        kgv[T] = kt * tl * gv;
      }
      float after = 0.f;  // sum over the later 16-step blocks
#pragma unroll
      for (int T = TB - 1; T >= 0; --T) {
        float x = rsd[T];
#pragma unroll
        for (int d = 1; d < 16; d *= 2) {
          const float y = __shfl_down_sync(kFull, x, d, 16);
          if (tq + d < 16) x += y;
        }
        float ex = __shfl_down_sync(kFull, x, 1, 16);
        rsd[T] = (tq == 15 ? 0.f : ex) + after;  // sum_{t' > t} r' (S dO)
        after += __shfl_sync(kFull, x, 0, 16);
      }
      float before = 0.f;
#pragma unroll
      for (int T = 0; T < TB; ++T) {
        float x = kgv[T];
#pragma unroll
        for (int d = 1; d < 16; d *= 2) {
          const float y = __shfl_up_sync(kFull, x, d, 16);
          if (tq >= d) x += y;
        }
        float ex = __shfl_up_sync(kFull, x, 1, 16);
        const float pre = (tq == 0 ? 0.f : ex) + before;  // sum_{s < t} k' (G v)
        before += __shfl_sync(kFull, x, 15, 16);
        const int t = 16 * T + tq;
        cross[ii * CP + t] += (start + rsd[T]) + pre;
      }
    }
    __syncthreads();

    // 5. dv's share and G's update on the tensor cores; dr, dk, dwlog out
    for (int n = warp; n < (TB + 1) * (K / 16); n += kWarps) {
      const int M = n / (K / 16), N = n % (K / 16);
      if (M < TB) {  // [A^T | k'^T] [dO ; G]: rows s, columns j
        float acc[2][4] = {};
        mma_tile<L + kRows>(
            acc, [&](int s, int x) { return x < L ? ad[x * AP + 16 * M + s] : kp[(16 * M + s) * RP + x - L]; },
            [&](int x, int j) { return x < L ? dos[x * KP + 16 * N + j] : gcur[(x - L) * KP + 16 * N + j]; },
            lane);
        float* sh = shares + (static_cast<int64_t>(blockIdx.y) * gridDim.x * seq) * K + off;
        tile_out(acc, lane, [&](int s, int j, float x) { sh[(16 * M + s) * K + 16 * N + j] = x; });
      } else {  // G <- e^(Lambda_{L-1}) G + r'^T dO
        const int g = lane >> 2, q = lane & 3;
        float acc[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 16 * N + 8 * h + 2 * q;
          acc[h][0] = elast[g] * gcur[g * KP + j];
          acc[h][1] = elast[g] * gcur[g * KP + j + 1];
          acc[h][2] = elast[g + 8] * gcur[(g + 8) * KP + j];
          acc[h][3] = elast[g + 8] * gcur[(g + 8) * KP + j + 1];
        }
        mma_tile<L>(acc, [&](int i, int t) { return rp[i * CP + t]; },
                    [&](int t, int j) { return dos[t * KP + 16 * N + j]; }, lane);
        tile_out(acc, lane, [&](int i, int j, float x) { gnext[i * KP + 16 * N + j] = x; });
      }
    }
    for (int x = tid; x < 3 * L * 4; x += kThreads) {  // channel-major in shared memory
      const int a = x / (4 * L), t = x / 4 % L, q = x % 4;
      const float* src = (a == 0 ? sdo : a == 1 ? gvs : cross) + 4 * q * CP + t;
      float* dst = a == 0 ? dr : a == 1 ? dk : dwlog;
      *reinterpret_cast<float4*>(dst + off + t * K + i0 + 4 * q) = make_float4(src[0], src[CP], src[2 * CP], src[3 * CP]);
    }
  }

  __syncthreads();
  const float* gfin = smem + B::oG + (n_chunks & 1) * kRows * KP;
  if (ds0 != nullptr)
    for (int x = tid; x < kRows * K; x += kThreads) {
      const int i = x / K, j = x % K;
      ds0[bh * kk + (i0 + i) * K + j] = gfin[i * KP + j];
    }
#pragma unroll
  for (int d = 8; d >= 1; d /= 2) du_acc += __shfl_xor_sync(kFull, du_acc, d);
  if (tq == 0) du_rows[bh * K + i0 + ii] = du_acc;
}

// dv = the sum of the splits' shares, in the order of the splits
__global__ void __launch_bounds__(kThreads)
    wkv_bwd_reduce_kernel(const float* __restrict__ shares, float* __restrict__ dv, int split,
                          int64_t n) {
  for (int64_t x = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; x < n;
       x += static_cast<int64_t>(gridDim.x) * kThreads) {
    float acc = shares[x];
    for (int q = 1; q < split; ++q) acc += shares[q * n + x];
    dv[x] = acc;
  }
}

struct Args {
  const float *r, *k, *v, *wlog, *u;
  int u_rows;
  const float *dout, *ds, *states;
  float *dr, *dk, *dv, *dwlog, *du_rows, *ds0, *scratch;
  int bh, seq;
  cudaStream_t stream;
};

template <int L, int K>
int launch_chunk(const Args& a) {
  using B = Bwd<L, K>;
  auto kernel = wkv_bwd_kernel<L, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // do not leave the error for the next launch's check
    return static_cast<int>(err);
  }
  if (B::kSplit > 1 && a.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* shares = B::kSplit > 1 ? a.scratch : a.dv;  // at K = 16 the one share is dv
  const dim3 grid(a.bh, B::kSplit);
  kernel<<<grid, kThreads, B::kBytes, a.stream>>>(a.r, a.k, a.v, a.wlog, a.u, a.u_rows, a.dout,
                                                   a.ds, a.states, a.dr, a.dk, shares,
                                                   a.dwlog, a.du_rows, a.ds0, a.seq);
  err = cudaGetLastError();
  if (err != cudaSuccess || B::kSplit == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(a.bh) * a.seq * K;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8192 ? want : 8192);
  wkv_bwd_reduce_kernel<<<blocks, kThreads, 0, a.stream>>>(shares, a.dv, B::kSplit, n);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int K>
int attrs_chunk(cudaFuncAttributes* out) {
  return static_cast<int>(cudaFuncGetAttributes(out, wkv_bwd_kernel<L, K>));
}

template <int L, int K>
int smem_chunk(int* bytes) {
  *bytes = Bwd<L, K>::kBytes;
  return 0;
}

// Calls F<L, K>(arg) for the compiled (chunk, K) pairs, those of csrc/wkv.cu.
#define WKV_BWD_CHUNKS(F, L_, K_, ARG)                       \
  switch ((L_) * 1000 + (K_)) {                              \
    case 16016: return F<16, 16>(ARG);                       \
    case 16032: return F<16, 32>(ARG);                       \
    case 16064: return F<16, 64>(ARG);                       \
    case 32016: return F<32, 16>(ARG);                       \
    case 32032: return F<32, 32>(ARG);                       \
    case 32064: return F<32, 64>(ARG);                       \
    case 64016: return F<64, 16>(ARG);                       \
    case 64032: return F<64, 32>(ARG);                       \
    case 64064: return F<64, 64>(ARG);                       \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

extern "C" {

// r, k, v, wlog, dout, dr, dk, dv, dwlog: (bh, seq, K) f32; u: (u_rows, K),
// row bh % u_rows for row bh; ds: (bh, K, K), the final state's gradient, or
// null for zeros; states: (bh, seq / chunk, K, K), the state at each chunk's
// start, as csrc/wkv.cu's wkv_launch writes them; du_rows: (bh, K),
// du of each row (the caller sums the rows that share a row of u); ds0:
// (bh, K, K), the initial state's gradient, or null; scratch: (K / 16, bh,
// seq, K) f32 for dv's shares where K > 16, summed by a second kernel (null
// at K = 16: the one share is dv).  Returns cudaGetLastError() after the
// launches (0 on success); argument errors return cudaErrorInvalidValue.
int wkv_bwd_launch(int chunk, int K, const float* r, const float* k, const float* v,
                   const float* wlog, const float* u, int u_rows, const float* dout,
                   const float* ds, const float* states, float* dr, float* dk, float* dv,
                   float* dwlog, float* du_rows, float* ds0, float* scratch, int bh, int seq,
                   void* stream) {
  if (bh < 1 || chunk < 1 || seq < chunk || seq % chunk || u_rows < 1 || bh % u_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r,  k,  v,     wlog,    u,   u_rows,  dout, ds,  states, dr,
               dk, dv, dwlog, du_rows, ds0, scratch, bh,   seq, static_cast<cudaStream_t>(stream)};
  WKV_BWD_CHUNKS(launch_chunk, chunk, K, a)
}

// Registers and local (spill) bytes per thread, the largest block, and the
// dynamic shared memory of the compiled instantiation.
int wkv_bwd_attributes(int chunk, int K, int* regs, int* local_bytes, int* max_threads,
                       int* smem_bytes) {
  cudaFuncAttributes a;
  int err = [&]() -> int { WKV_BWD_CHUNKS(attrs_chunk, chunk, K, &a) }();
  if (err != 0) return err;
  err = [&]() -> int { WKV_BWD_CHUNKS(smem_chunk, chunk, K, smem_bytes) }();
  if (err != 0) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
