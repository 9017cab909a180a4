// Gradient of the chunked RWKV6 WKV recurrence, for Hopper (sm_90a).
//
// The Pallas TPU kernel `wkv_pallas` (src/repro/kernels/wkv/kernel.py) has
// no backward: the JAX package differentiates its scan, `_wkv_scan` in
// src/repro/models/rwkv6.py.  This kernel computes that gradient in the
// chunked form of csrc/wkv.cu, the chunks in reverse, carrying G, the
// gradient of the state at the chunk's end.  Per (batch*head) and chunk of
// L steps, with Lambda the running sum of wlog over the chunk (Lambda_{-1} =
// 0), S the state at the chunk's start (saved by the forward), A[t][s] =
// sum_i r_t e^(Lambda_{t-1} - Lambda_s) k_s for s < t, b_t = r_t . (u * k_t)
// and delta_ts = dO_t . v_s:
//
//   dv_s  = sum_{t>s} A[t][s] dO_t + b_s dO_s + (k_s e^(Lambda_{L-1} - Lambda_s)) G
//   dr~_t = sum_{s<t} e^(Lambda_{t-1} - Lambda_s) k_s delta_ts + e^(Lambda_{t-1}) (S dO_t)
//   dk~_s = sum_{t>s} r_t e^(Lambda_{t-1} - Lambda_s) delta_ts + e^(Lambda_{L-1} - Lambda_s) (G v_s)
//   dr_t  = dr~_t + u k_t delta_tt ;  dk_s = dk~_s + r_s u delta_ss ;  du += r_t k_t delta_tt
//   dwlog_tau = e^(Lambda_{L-1}) sum_j G_ij S_ij
//             + sum_{s<tau} k_s e^(Lambda_{L-1} - Lambda_s) (G v_s)
//             + sum_{t>tau} r_t e^(Lambda_{t-1}) (S dO_t)
//             + sum_{s<tau<t} r_t e^(Lambda_{t-1} - Lambda_s) k_s delta_ts
//   G <- e^(Lambda_{L-1}) G + sum_t (r_t e^(Lambda_{t-1})) dO_t^T
//
// and ds0 is G after the first chunk.  dwlog_tau is the state's gradient
// after step tau times e^(wlog_tau) times the state before it, split at the
// chunk's start and at tau: each term carries the decay of step tau, so a
// channel that forgets fast has a small dwlog computed from small terms.  (The
// same sum as reverse cumsums of dLambda, sum_j G_ij S'_ij less what the steps
// from tau on injected, cancels there: a hundred times the f32 plain
// version's error at RWKV6-1.6B's width.)  Every exponent is a difference that
// is <= 0 (wlog <= 0), as in the forward; e^(-Lambda) alone is never formed.
// kernels/wkv/ref.py's wkv_bwd_plain is the same computation in PyTorch.
//
// Design: one block of 256 threads per (batch*head, 16 rows i of the state).
// Every term above is separable in i (the key channel) except dv, which sums
// over i: so each block owns rows i0 .. i0 + 15 of G (in shared memory) and
// computes dr, dk, dwlog and du for its 16 channels completely, and its
// share of dv over those channels.  With K / 16 blocks a row, the shares go
// to a scratch buffer (split, BH, S, K), and a second kernel sums them in
// the order of the splits: no atomics, the same bits every run.  At K = 16
// the one share is dv itself.  Per chunk, with barriers between:
//   0. load r, k, wlog (the block's 16 channels), v, dO (all K), and the
//      block's rows of S;
//   1. Lambda down t (16 threads), sum_j G_ij S_ij (16 more), delta_ts for
//      s <= t (all);
//   2. per (t, i): dr and dk written; r e^(Lambda_{t-1}), k e^(Lambda_{L-1} -
//      Lambda_t), dwlog's terms at t; per (t, s): A over the 16 channels,
//      b on the diagonal;
//   3. dwlog by a scan down t and one up (16 threads); dv's share per (s, j);
//   4. G <- e^(Lambda_{L-1}) G + (r e^(Lambda_{t-1}))^T dO.
// Scalar f32 FMAs throughout: a simple design, to be made fast later (the
// port's PERF.md has its time against its bound).
//
// Shared memory, in f32: r, k, Lambda, r', k', three of dwlog's terms (L x 16
// each); v, dO (L x (K+1)); S, G (16 x (K+1)); A, delta (L x (L+1)).  31 KB at
// L = 16, K = 64; 109 KB at L = K = 64.  Dynamic shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows i of the state per block
constexpr int kMaxSmemBytes = 232448;

template <int L, int K>
struct Bwd {
  static constexpr int kSplit = K / kRows;
  static constexpr int kP = K + 1;   // padded row of an (., K) array
  static constexpr int kLP = L + 1;  // padded row of an (L, L) array
  static constexpr int kSlice = L * kRows;
  static constexpr int kFull = L * kP;
  static constexpr int kState = kRows * kP;
  static constexpr int kSquare = L * kLP;
  static constexpr int kFloats = 8 * kSlice + 2 * kFull + 2 * kState + 2 * kSquare + 2 * kRows + kThreads;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * kFloats;
  static_assert(K % kRows == 0 && kThreads % kRows == 0 && kThreads % K == 0, "whole row groups");
  static_assert(kBytes <= kMaxSmemBytes, "chunk exceeds the shared memory of an H100 block");
};

template <int L, int K>
__global__ void __launch_bounds__(kThreads)
    wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ wlog,
                   const float* __restrict__ u, int u_rows, const float* __restrict__ dout,
                   const float* __restrict__ ds, const float* __restrict__ states,
                   float* __restrict__ dr,
                   float* __restrict__ dk, float* __restrict__ dv_share,
                   float* __restrict__ dwlog, float* __restrict__ du_rows,
                   float* __restrict__ ds0, int seq) {
  using B = Bwd<L, K>;
  constexpr int P = B::kP;
  constexpr int LP = B::kLP;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                 // [L][16]
  float* ks = rs + B::kSlice;       // [L][16]
  float* lam = ks + B::kSlice;      // [L][16]: wlog, then Lambda
  float* rp = lam + B::kSlice;      // [L][16]: r e^(Lambda_{t-1})
  float* kp = rp + B::kSlice;       // [L][16]: k e^(Lambda_{L-1} - Lambda_t)
  float* rsd = kp + B::kSlice;      // [L][16]: r e^(Lambda_{t-1}) (S dO_t)
  float* kgv = rsd + B::kSlice;     // [L][16]: k e^(Lambda_{L-1} - Lambda_t) (G v_t)
  float* cross = kgv + B::kSlice;   // [L][16]: dwlog's sum over s < tau < t, then dwlog less the prefix
  float* vs = cross + B::kSlice;    // [L][K+1]
  float* dos = vs + B::kFull;       // [L][K+1]
  float* st = dos + B::kFull;       // [16][K+1]: S
  float* g = st + B::kState;        // [16][K+1]: G
  float* a = g + B::kState;         // [L][L+1]: A, b on the diagonal, 0 above
  float* delta = a + B::kSquare;    // [L][L+1]: delta for s <= t
  float* us = delta + B::kSquare;   // [16]
  float* gs = us + kRows;           // [16]: sum_j G_ij S_ij
  float* red = gs + kRows;          // [256]: du's partial sums

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int i0 = blockIdx.y * kRows;
  const int n_chunks = seq / L;
  const int64_t base = static_cast<int64_t>(bh) * seq * K;
  const int64_t kk = static_cast<int64_t>(K) * K;
  float* share = dv_share + static_cast<int64_t>(blockIdx.y) * gridDim.x * seq * K;

  if (tid < kRows) us[tid] = u[(bh % u_rows) * K + i0 + tid];
  for (int x = tid; x < kRows * K; x += kThreads) {
    const int ii = x / K, j = x % K;
    g[ii * P + j] = ds != nullptr ? ds[bh * kk + (i0 + ii) * K + j] : 0.f;
  }
  float du_acc = 0.f;  // channel i0 + tid % 16, over this thread's t

  for (int c = n_chunks - 1; c >= 0; --c) {
    // 0. loads
    const int64_t off = base + static_cast<int64_t>(c) * L * K;
    for (int x = tid; x < B::kSlice; x += kThreads) {
      const int64_t at = off + (x / kRows) * K + i0 + x % kRows;
      rs[x] = r[at];
      ks[x] = k[at];
      lam[x] = wlog[at];
    }
    for (int x = tid; x < L * K; x += kThreads) {
      const int t = x / K, j = x % K;
      vs[t * P + j] = v[off + x];
      dos[t * P + j] = dout[off + x];
    }
    const float* sg = states + (static_cast<int64_t>(bh) * n_chunks + c) * kk;
    for (int x = tid; x < kRows * K; x += kThreads) {
      const int ii = x / K, j = x % K;
      st[ii * P + j] = sg[(i0 + ii) * K + j];
    }
    __syncthreads();

    // 1. Lambda, sum_j G S, delta
    if (tid < kRows) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        acc += lam[t * kRows + tid];
        lam[t * kRows + tid] = acc;
      }
    } else if (tid < 2 * kRows) {
      const int ii = tid - kRows;
      float acc = 0.f;
      for (int j = 0; j < K; ++j) acc = fmaf(g[ii * P + j], st[ii * P + j], acc);
      gs[ii] = acc;
    }
    for (int x = tid; x < L * L; x += kThreads) {
      const int t = x / L, s = x % L;
      if (s <= t) {
        float acc = 0.f;
#pragma unroll 8
        for (int j = 0; j < K; ++j) acc = fmaf(dos[t * P + j], vs[s * P + j], acc);
        delta[t * LP + s] = acc;
      }
    }
    __syncthreads();

    // 2. per (t, i): dr, dk, dwlog's terms; per (t, s): A
    for (int x = tid; x < B::kSlice; x += kThreads) {
      const int t = x / kRows, ii = x % kRows;
      const float lp = t > 0 ? lam[x - kRows] : 0.f;
      const float lt = lam[x];
      const float el = expf(lp);                                 // e^(Lambda_{t-1})
      const float tl = expf(lam[(L - 1) * kRows + ii] - lt);     // e^(Lambda_{L-1} - Lambda_t)
      float drt = 0.f, dkt = 0.f;
      for (int s = 0; s < t; ++s)
        drt = fmaf(expf(lp - lam[s * kRows + ii]) * ks[s * kRows + ii], delta[t * LP + s], drt);
      for (int t2 = t + 1; t2 < L; ++t2)
        dkt = fmaf(rs[t2 * kRows + ii] * expf(lam[(t2 - 1) * kRows + ii] - lt), delta[t2 * LP + t], dkt);
      float sd = 0.f, gv = 0.f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) {
        sd = fmaf(st[ii * P + j], dos[t * P + j], sd);
        gv = fmaf(g[ii * P + j], vs[t * P + j], gv);
      }
      drt = fmaf(el, sd, drt);
      dkt = fmaf(tl, gv, dkt);
      const float rt = rs[x], kt = ks[x], dtt = delta[t * LP + t];
      const int64_t at = off + t * K + i0 + ii;
      dr[at] = fmaf(us[ii] * kt, dtt, drt);
      dk[at] = fmaf(rt * us[ii], dtt, dkt);
      du_acc = fmaf(rt * kt, dtt, du_acc);
      rp[x] = rt * el;
      kp[x] = kt * tl;
      rsd[x] = rt * el * sd;
      kgv[x] = kt * tl * gv;
      // sum_{s<t<t2} r_t2 e^(Lambda_{t2-1} - Lambda_s) k_s delta_{t2 s}, the exponent
      // split at t as two differences <= 0; e^(Lambda_t - Lambda_s) k_s for s < t
      // in registers (unrolled over every s, the rest predicated off)
      float ks_t[L];
#pragma unroll
      for (int s = 0; s < L; ++s) ks_t[s] = s < t ? expf(lt - lam[s * kRows + ii]) * ks[s * kRows + ii] : 0.f;
      float cr = 0.f;
      for (int t2 = t + 1; t2 < L; ++t2) {
        float inner = 0.f;
#pragma unroll
        for (int s = 0; s < L; ++s)
          if (s < t) inner = fmaf(ks_t[s], delta[t2 * LP + s], inner);
        cr = fmaf(expf(lam[(t2 - 1) * kRows + ii] - lt) * rs[t2 * kRows + ii], inner, cr);
      }
      cross[x] = cr;
    }
    for (int x = tid; x < L * L; x += kThreads) {
      const int t = x / L, s = x % L;
      float acc = 0.f;
      if (s < t) {
        for (int ii = 0; ii < kRows; ++ii)
          acc = fmaf(rs[t * kRows + ii] * expf(lam[(t - 1) * kRows + ii] - lam[s * kRows + ii]),
                     ks[s * kRows + ii], acc);
      } else if (s == t) {
        for (int ii = 0; ii < kRows; ++ii)
          acc = fmaf(rs[t * kRows + ii] * us[ii], ks[t * kRows + ii], acc);
      }
      a[t * LP + s] = acc;
    }
    __syncthreads();

    // 3. dwlog: the chunk-start term and the sums over t > tau (down), then
    // over s < tau (up); dv's share
    if (tid < kRows) {
      const float start = expf(lam[(L - 1) * kRows + tid]) * gs[tid];
      float after = 0.f;
      for (int m = L - 1; m >= 0; --m) {
        cross[m * kRows + tid] += start + after;
        after += rsd[m * kRows + tid];
      }
      float before = 0.f;
      for (int m = 0; m < L; ++m) {
        dwlog[off + m * K + i0 + tid] = cross[m * kRows + tid] + before;
        before += kgv[m * kRows + tid];
      }
    }
    for (int x = tid; x < L * K; x += kThreads) {
      const int s = x / K, j = x % K;
      float acc = 0.f;
      for (int t = s; t < L; ++t) acc = fmaf(a[t * LP + s], dos[t * P + j], acc);
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) acc = fmaf(kp[s * kRows + ii], g[ii * P + j], acc);
      share[off + x] = acc;
    }
    __syncthreads();

    // 4. G <- e^(Lambda_{L-1}) G + (r e^(Lambda_{t-1}))^T dO
    for (int x = tid; x < kRows * K; x += kThreads) {
      const int ii = x / K, j = x % K;
      float acc = expf(lam[(L - 1) * kRows + ii]) * g[ii * P + j];
      for (int t = 0; t < L; ++t) acc = fmaf(rp[t * kRows + ii], dos[t * P + j], acc);
      g[ii * P + j] = acc;
    }
    __syncthreads();
  }

  if (ds0 != nullptr)
    for (int x = tid; x < kRows * K; x += kThreads) {
      const int ii = x / K, j = x % K;
      ds0[bh * kk + (i0 + ii) * K + j] = g[ii * P + j];
    }
  red[tid] = du_acc;
  __syncthreads();
  if (tid < kRows) {
    float acc = 0.f;
    for (int m = 0; m < kThreads / kRows; ++m) acc += red[m * kRows + tid];
    du_rows[bh * K + i0 + tid] = acc;
  }
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
  float* shares = B::kSplit > 1 ? a.scratch : a.dv;
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
// (bh, K, K), the initial state's gradient, or null; scratch: (K / 16, bh, seq, K) f32 for dv's shares where K > 16 (null
// at K = 16).  Returns cudaGetLastError() after the launches (0 on
// success); argument errors return cudaErrorInvalidValue.
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
