// Chunked RWKV6 WKV recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_kernel` / `wkv_pallas` in
// src/repro/kernels/wkv/kernel.py.  Per (batch*head) and chunk of L steps,
// with Lambda the running sum of wlog over the chunk (Lambda_{-1} = 0):
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
// Bound on the H100: device-memory bytes.  r, k, v and wlog are read once
// and out written once: 20 bytes per (token, channel) against about 6 K
// flops per (token, channel) for the recurrence, so at K = 64 the byte
// bound and the f32 operation bound (67 TFLOP/s) are close, with bytes
// slightly ahead.  The chunked form keeps the state out of device memory
// (the naive scan would read and write it every step), which is what puts
// bytes within reach.
//
// Design: one thread block of 256 threads per (batch*head, 16 columns of v),
// with the loop over chunks inside it.  A = the decayed r.k does not depend
// on v, and the columns of v, out and the state are independent, so the K
// columns of v go to K / 16 blocks: at RWKV6-1.6B's width (BH = 64, K = 64)
// 256 blocks on 132 SMs, where one block per (batch*head) left 68 idle.  Each
// block computes A in full (K / 16 times the exps of one block per head) and
// owns its K x 16 slice of the state, where the TPU kernel keeps the whole
// state in VMEM scratch across its sequential grid axis.  Per chunk:
//   0. r, k, wlog and the v slice of chunk c + 1 are copied with cp.async
//      into the other of two stages while chunk c computes;
//   1. Lambda = the running sum of wlog down t: a shuffle scan per column,
//      min(L, 32) lanes down t;
//   2. A[t][s] for s <= t by 4 x 4 tiles of (t, s), a warp per tile with its
//      lanes along j, so each row read from shared memory feeds 4 entries,
//      and one reduce-scatter over the warp; beside it r' = r exp(Lambda_{t-1})
//      and k' = k exp(Lambda_{L-1} - Lambda_s);
//   3. out = A v + r' S: the state slice lives in registers, 4 x 1 per
//      thread (K / 4 threads per column); each thread sums its share for all
//      t, and a reduce-scatter over the column's threads leaves L / (K / 4)
//      rows of out on each;
//   4. S = exp(Lambda_{L-1}) S + k'^T v, in the same registers.
// Three barriers per chunk.  The final state is written from the registers.
// The bonus u is one row of K for every block, or one per head (row
// blockIdx.x % H, the models' layout bh = b H + h); an initial state s0, where
// given, seeds each owner's registers (a prefill continuing a cached state).
// Where the caller asks for them (training: csrc/wkv_bwd.cu reads them), the
// state at each chunk's start is written too: staged before the first
// barrier in a K x 16 buffer (4 KB of static shared memory at K = 64) and
// written between the first and the second, so that each row of the block's
// slice goes out as 64 contiguous bytes.
// What limits it (the port's PERF.md): shared-memory wavefronts first, so
// steps 2 and 3 keep operands in registers where a row would be read again;
// then issuing step 2's L^2 K / 2 exps (accurate expf).
//
// Shared memory, in f32: two stages of r, k, wlog (L x (K+8) each, rows
// 16-byte aligned for cp.async) and v (L x 16); r', k' (L x (K+8)); A
// (L x (L+1), 0 above the diagonal).  39 KB at L = 16, K = 64; 168 KB at
// L = K = 64.  Dynamic shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVC = 16;  // columns of v, out and the state per block
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
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

template <int L, int K>
struct Chunk {
  static constexpr int kRow = K + 8;  // padded row of an (L, K) array
  static constexpr int kArr = L * kRow;
  static constexpr int kStage = 3 * kArr + L * kVC;  // r, k, wlog, v slice
  static constexpr int kA = L * (L + 1);
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * (2 * kStage + 2 * kArr + kA);
  static constexpr int kScan = L < 32 ? L : 32;            // lanes down t per column
  static constexpr int kScanCols = kWarps * (32 / kScan);  // columns per scan pass
  static constexpr int kElems = L * K / kThreads;          // r', k' entries per thread
  static constexpr int kTileRows = L / 4;                  // 4 x 4 tiles of A per side
  static constexpr int kTiles = kTileRows * (kTileRows + 1) / 2;  // on or below the diagonal
  static constexpr int kJ = (K + 31) / 32;                 // j per lane in step 2
  static constexpr int kGroup = K / 4;  // threads of one state column, one j quad each
  static constexpr int kOwners = kGroup * kVC;             // threads that own state
  static constexpr int kOut = L / kGroup;                  // outputs per owner
  static_assert(kOwners <= kThreads && kThreads % kGroup == 0 && L % kGroup == 0,
                "one 4 x 1 state tile per owner, whole lane groups");
  static_assert(K % kScanCols == 0 && L * K % kThreads == 0, "whole scan passes and rounds");
  static_assert(kBytes + static_cast<int>(sizeof(float)) * K * (1 + kVC) <= kMaxSmemBytes,
                "chunk exceeds the shared memory of an H100 block");
};

// r, k, wlog (L x K each) and the v slice (L x 16) of one chunk into a stage
template <int L, int K>
__device__ __forceinline__ void prefetch(float* dst, const float* r, const float* k,
                                         const float* wlog, const float* v, int64_t off, int col0,
                                         int tid) {
  using C = Chunk<L, K>;
  constexpr int kq = K / 4;
  for (int i = tid; i < L * kq; i += kThreads) {
    const int t = i / kq, j = i % kq * 4;
    cp_async16(dst + t * C::kRow + j, r + off + t * K + j);
    cp_async16(dst + C::kArr + t * C::kRow + j, k + off + t * K + j);
    cp_async16(dst + 2 * C::kArr + t * C::kRow + j, wlog + off + t * K + j);
  }
  for (int i = tid; i < L * kVC / 4; i += kThreads) {
    const int t = i / (kVC / 4), e = i % (kVC / 4) * 4;
    cp_async16(dst + 3 * C::kArr + t * kVC + e, v + off + t * K + col0 + e);
  }
}

// Sums N values of each lane over the G lanes of its group (G a power of 2,
// groups aligned in the warp), by recursive halving: lane g of the group
// ends with the sums of values [g N / G, (g + 1) N / G) in x[0 .. N / G),
// or, where N < G, of value g / (G / N) in x[0].
template <int N, int G>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int g) {
  int n = N;
#pragma unroll
  for (int d = G / 2; d >= 1; d /= 2) {
    if (n > 1) {
      const bool up = g & d;
      const int h = n / 2;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        if (i < h) {
          const float keep = up ? x[i + h] : x[i];
          const float send = up ? x[i] : x[i + h];
          x[i] = keep + __shfl_xor_sync(0xffffffffu, send, d);
        }
      }
      n = h;
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], d);
    }
  }
}

template <int L, int K>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ wlog,
               const float* __restrict__ u, int u_rows, const float* __restrict__ s0,
               float* __restrict__ out, float* __restrict__ state_out,
               float* __restrict__ states, int seq) {
  using C = Chunk<L, K>;
  constexpr int P = C::kRow;
  constexpr int W = C::kScan;
  constexpr int G = C::kGroup;
  extern __shared__ __align__(16) float smem[];
  float* rp = smem + 2 * C::kStage;  // [L][K+8]: r * exp(Lambda_{t-1})
  float* kp = rp + C::kArr;          // [L][K+8]: k * exp(Lambda_{L-1} - Lambda_s)
  float* a = kp + C::kArr;           // [L][L+1], 0 above the diagonal
  __shared__ float us[K];
  __shared__ float stage[K * kVC];  // the chunk-start state slice, where states is given
  __shared__ unsigned char tiles[C::kTiles];  // row tile << 4 | column tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.y * kVC;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * seq * K;
  for (int i = tid; i < C::kA; i += kThreads) a[i] = 0.f;
  const float* ub = u + (blockIdx.x % u_rows) * K;  // row bh % H of u (H, K), or u (K,)
  for (int i = tid; i < K; i += kThreads) us[i] = ub[i];
  if (tid == 0) {
    int i = 0;
    for (int tg = 0; tg < C::kTileRows; ++tg)
      for (int sg = 0; sg <= tg; ++sg) tiles[i++] = static_cast<unsigned char>(tg << 4 | sg);
  }
  // this thread's 4 x 1 tile of the state slice: rows jq .. jq + 3, column e
  const bool owner = tid < C::kOwners;
  const int g = tid % G;  // lane in its group of G
  const int jq = g * 4, e = tid / G % kVC;
  float sreg[4] = {0.f, 0.f, 0.f, 0.f};
  if (s0 != nullptr && owner) {
    const float* sb = s0 + static_cast<int64_t>(blockIdx.x) * K * K;
#pragma unroll
    for (int q = 0; q < 4; ++q) sreg[q] = sb[(jq + q) * K + col0 + e];
  }

  const int n_chunks = seq / L;
  prefetch<L, K>(smem, r, k, wlog, v, base, col0, tid);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    if (states != nullptr && owner)
#pragma unroll
      for (int q = 0; q < 4; ++q) stage[(jq + q) * kVC + e] = sreg[q];
    cp_async_wait<0>();  // chunk c has landed
    __syncthreads();     // ... for every thread; chunk c - 1 is done with the other stage
    if (c + 1 < n_chunks)
      prefetch<L, K>(smem + ((c + 1) & 1) * C::kStage, r, k, wlog, v,
                     base + static_cast<int64_t>(c + 1) * L * K, col0, tid);
    cp_async_commit();
    if (states != nullptr) {  // (bh, c, K, K): this block's 16 columns of each row
      float* sc = states + (static_cast<int64_t>(blockIdx.x) * n_chunks + c) * K * K + col0;
      for (int i = tid; i < K * kVC; i += kThreads) sc[i / kVC * K + i % kVC] = stage[i];
    }
    const float* rs = smem + (c & 1) * C::kStage;  // [L][K+8]
    const float* ks = rs + C::kArr;                // [L][K+8]
    float* lam = smem + (c & 1) * C::kStage + 2 * C::kArr;  // [L][K+8]: wlog, then Lambda
    const float* vs = lam + C::kArr;               // [L][16]

    // 1. Lambda: inclusive scan down t, W lanes per column, segments of W
#pragma unroll
    for (int pass = 0; pass < K / C::kScanCols; ++pass) {
      const int j = pass * C::kScanCols + warp * (32 / W) + lane / W, tl = lane % W;
      float carry = 0.f;
#pragma unroll
      for (int t0 = 0; t0 < L; t0 += W) {
        float x = lam[(t0 + tl) * P + j];
#pragma unroll
        for (int off = 1; off < W; off *= 2) {
          const float y = __shfl_up_sync(0xffffffffu, x, off, W);
          if (tl >= off) x += y;
        }
        x += carry;
        lam[(t0 + tl) * P + j] = x;
        carry = __shfl_sync(0xffffffffu, x, W - 1, W);
      }
    }
    __syncthreads();

    // 2. A[t][s]: decayed r.k for s < t, the bonus r.(u*k) on s = t, by
    // 4 x 4 tiles of (t, s), one warp each.  Lanes run along j, so each row
    // read from shared memory feeds 4 entries; each lane sums its j for all
    // 16 entries, and one reduce-scatter over the warp leaves entry lane / 2
    // on lanes 2m and 2m + 1.  Every lane runs the same instructions (the
    // factor is selected, not branched on).
    for (int i = warp; i < C::kTiles; i += kWarps) {
      const int t0 = tiles[i] >> 4 << 2, s0 = (tiles[i] & 15) << 2;
      float x[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) x[q] = 0.f;
#pragma unroll
      for (int m = 0; m < C::kJ; ++m) {
        const int j = lane + 32 * m;
        if (K % 32 == 0 || j < K) {
          float rt[4], lp[4], ls[4], kk[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            rt[q] = rs[(t0 + q) * P + j];
            lp[q] = lam[max(t0 + q - 1, 0) * P + j];
            ls[q] = lam[(s0 + q) * P + j];
            kk[q] = ks[(s0 + q) * P + j];
          }
          const float uj = us[j];
#pragma unroll
          for (int ta = 0; ta < 4; ++ta)
#pragma unroll
            for (int sb = 0; sb < 4; ++sb) {
              const int t = t0 + ta, s = s0 + sb;
              const float e = expf(lp[ta] - ls[sb]);
              const float w = s < t ? e : (s == t ? uj : 0.f);
              x[ta * 4 + sb] = fmaf(rt[ta] * w, kk[sb], x[ta * 4 + sb]);
            }
        }
      }
      reduce_scatter<16, 32>(x, lane);
      const int t = t0 + lane / 8, s = s0 + lane / 2 % 4;
      if (lane % 2 == 0 && s <= t) a[t * (L + 1) + s] = x[0];
    }
    const float* last = lam + (L - 1) * P;
#pragma unroll
    for (int n = 0; n < C::kElems; ++n) {
      const int i = tid + n * kThreads;
      const int t = i / K, j = i % K;
      rp[t * P + j] = t > 0 ? rs[t * P + j] * expf(lam[(t - 1) * P + j]) : rs[t * P + j];
      kp[t * P + j] = ks[t * P + j] * expf(last[j] - lam[t * P + j]);
    }
    __syncthreads();

    // 3. out[t][e] = sum_{s<=t} A[t][s] v[s][e] + sum_j r'[t][j] S[j][e].
    // A group of G threads holds column e of the state slice, 4 rows each;
    // each thread sums its 4 rows of r' S and every G-th s of A v for all
    // t, and a reduce-scatter over the group leaves L / G rows of out on
    // each thread.
    {
      float x[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float4 rv = *reinterpret_cast<const float4*>(rp + t * P + jq);
        float y = rv.x * sreg[0];
        y = fmaf(rv.y, sreg[1], y);
        y = fmaf(rv.z, sreg[2], y);
        x[t] = fmaf(rv.w, sreg[3], y);
      }
#pragma unroll
      for (int m = 0; m < L / G; ++m) {
        const int s = g + G * m;
        const float vv = vs[s * kVC + e];
#pragma unroll
        for (int t = 0; t < L; ++t) x[t] = fmaf(a[t * (L + 1) + s], vv, x[t]);
      }
      reduce_scatter<L, G>(x, g);
      if (owner)
#pragma unroll
        for (int i = 0; i < C::kOut; ++i)
          out[base + static_cast<int64_t>(c * L + g * C::kOut + i) * K + col0 + e] = x[i];
    }

    // 4. S[j][e] = exp(Lambda_{L-1}[j]) S[j][e] + sum_s k'[s][j] v[s][e], in registers
    if (owner) {
      float inj[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const float4 kv = *reinterpret_cast<const float4*>(kp + s * P + jq);
        const float vv = vs[s * kVC + e];
        inj[0] = fmaf(kv.x, vv, inj[0]);
        inj[1] = fmaf(kv.y, vv, inj[1]);
        inj[2] = fmaf(kv.z, vv, inj[2]);
        inj[3] = fmaf(kv.w, vv, inj[3]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sreg[q] = expf(last[jq + q]) * sreg[q] + inj[q];
    }
  }

  if (owner) {
    float* so = state_out + static_cast<int64_t>(blockIdx.x) * K * K;
#pragma unroll
    for (int q = 0; q < 4; ++q) so[(jq + q) * K + col0 + e] = sreg[q];
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

template <int L, int K>
int launch_chunk(const Args& a) {
  using C = Chunk<L, K>;
  auto kernel = wkv_kernel<L, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // do not leave the error for the next launch's check
    return static_cast<int>(err);
  }
  const dim3 grid(a.bh, K / kVC);
  kernel<<<grid, kThreads, C::kBytes, a.stream>>>(a.r, a.k, a.v, a.wlog, a.u, a.u_rows, a.s0,
                                                   a.out, a.state, a.states, a.seq);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int K>
int attrs_chunk(cudaFuncAttributes* out) {
  return static_cast<int>(cudaFuncGetAttributes(out, wkv_kernel<L, K>));
}

// Calls F<L, K>(arg) for the compiled (chunk, K) pairs.
#define WKV_CHUNKS(F, L_, K_, ARG)                           \
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

// r, k, v, wlog, out: (bh, seq, K) f32; u: (u_rows, K), row bh % u_rows
// for row bh of the others (u_rows = 1: one u for all; u_rows = H with
// bh = b H + h: one per head); s0: (bh, K, K), the initial state, or null
// for zeros; state: (bh, K, K), the final state; states: (bh, seq / chunk,
// K, K), the state at each chunk's start (s0 or zeros at the first), or null
// for none.  Returns cudaGetLastError() after the launch (0 on success);
// argument errors return cudaErrorInvalidValue.
int wkv_launch(int chunk, int K, const float* r, const float* k, const float* v,
               const float* wlog, const float* u, int u_rows, const float* s0, float* out,
               float* state, float* states, int bh, int seq, void* stream) {
  if (bh < 1 || chunk < 1 || seq % chunk || u_rows < 1 || bh % u_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, wlog, u, u_rows, s0, out, state, states, bh, seq,
               static_cast<cudaStream_t>(stream)};
  WKV_CHUNKS(launch_chunk, chunk, K, a)
}

// Registers and local (spill) bytes per thread, and the largest block, of
// the compiled instantiation.
int wkv_attributes(int chunk, int K, int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes a;
  const int err = [&]() -> int { WKV_CHUNKS(attrs_chunk, chunk, K, &a) }();
  if (err != 0) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
