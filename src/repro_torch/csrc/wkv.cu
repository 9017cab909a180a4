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
// Design: one thread block per (batch*head), with the loop over chunks
// inside it; the (K, K) f32 state lives in shared memory across the loop,
// where the TPU kernel keeps it in VMEM scratch across its sequential grid
// axis.  Per chunk, 256 threads
//   1. load r, k, v, wlog (L x K f32 each) into shared memory;
//   2. take the running sum over t, one thread per column;
//   3. form A[t][s] = sum_k r[t,k] exp(Lambda[t-1,k] - Lambda[s,k]) k[s,k]
//      for s < t, and the bonus on s = t;
//   4. scale r by exp(Lambda_{t-1}) and k by exp(Lambda_{L-1} - Lambda_s);
//   5. write out = A v + r' S, one thread per (t, column);
//   6. update S = exp(Lambda_{L-1}) S + k'^T v, one thread per entry.
// The final state is written out after the last chunk.
//
// Bound on the H100: device-memory bytes.  r, k, v and wlog are read once
// and out written once: 20 bytes per (token, channel) against about 6 K
// flops per (token, channel) for the recurrence, so at K = 64 the byte
// bound and the f32 operation bound (67 TFLOP/s) are close, with bytes
// slightly ahead.  The chunked form keeps the state out of device memory
// (the naive scan would read and write it every step), which is what puts
// bytes within reach.  What this first kernel does not do: it runs one block
// per (batch*head), so at 32 heads and batch 2 only 64 of the 132 SMs work,
// and step 3's exps (L^2 K / 2 per chunk) run on the SFU in f32.  Splitting
// the columns of v and S across blocks is later work: A does not depend on
// v, and the columns of S are independent.
//
// Shared memory, in f32: r, k, v, Lambda ((L x (K+1)) each, padded so that
// a warp reading down a column touches distinct banks), A (L x (L+1)) and S
// (K x K); about 100 KB at L = K = 64, dynamic shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int L, int K>
struct Chunk {
  static constexpr int kRow = K + 1;  // padded row of an (L, K) array
  static constexpr int kArr = L * kRow;
  static constexpr int kA = L * (L + 1);
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * (4 * kArr + kA + K * K);
};

template <int L, int K>
__global__ void __launch_bounds__(kThreads)
    wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ wlog,
               const float* __restrict__ u, float* __restrict__ out,
               float* __restrict__ state_out, int seq) {
  using C = Chunk<L, K>;
  constexpr int P = C::kRow;
  extern __shared__ float smem[];
  float* rs = smem;            // [L][K+1]: r, then r * exp(Lambda_{t-1})
  float* ks = rs + C::kArr;    // [L][K+1]: k, then k * exp(Lambda_{L-1} - Lambda_s)
  float* vs = ks + C::kArr;    // [L][K+1]
  float* lam = vs + C::kArr;   // [L][K+1]: wlog, then its running sum Lambda
  float* a = lam + C::kArr;    // [L][L+1]
  float* st = a + C::kA;       // [K][K], the state
  __shared__ float us[K];

  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * seq * K;
  for (int i = tid; i < K * K; i += kThreads) st[i] = 0.f;
  for (int i = tid; i < K; i += kThreads) us[i] = u[i];

  const int n_chunks = seq / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t off = base + static_cast<int64_t>(c) * L * K;
    __syncthreads();  // the previous chunk is done with r, k, v, Lambda and A
    for (int i = tid; i < L * K; i += kThreads) {
      const int j = (i / K) * P + i % K;
      rs[j] = r[off + i];
      ks[j] = k[off + i];
      vs[j] = v[off + i];
      lam[j] = wlog[off + i];
    }
    __syncthreads();
    if (tid < K) {
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += lam[t * P + tid];
        lam[t * P + tid] = run;
      }
    }
    __syncthreads();

    // A[t][s]: decayed r.k for s < t, the bonus r.(u*k) on s = t, 0 above
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, s = i % L;
      float x = 0.f;
      if (s < t) {
        const float* rt = rs + t * P;
        const float* lp = lam + (t - 1) * P;
        const float* ls = lam + s * P;
        const float* kk = ks + s * P;
#pragma unroll 8
        for (int j = 0; j < K; ++j) x = fmaf(rt[j] * expf(lp[j] - ls[j]), kk[j], x);
      } else if (s == t) {
        const float* rt = rs + t * P;
        const float* kk = ks + t * P;
#pragma unroll 8
        for (int j = 0; j < K; ++j) x = fmaf(rt[j], us[j] * kk[j], x);
      }
      a[t * (L + 1) + s] = x;
    }
    __syncthreads();

    const float* last = lam + (L - 1) * P;
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, j = i % K;
      if (t > 0) rs[t * P + j] *= expf(lam[(t - 1) * P + j]);
      ks[t * P + j] *= expf(last[j] - lam[t * P + j]);
    }
    __syncthreads();

    // out[t][e] = sum_{s<=t} A[t][s] v[s][e] + sum_j r'[t][j] S[j][e]
    for (int i = tid; i < L * K; i += kThreads) {
      const int t = i / K, e = i % K;
      float x = 0.f;
      for (int s = 0; s <= t; ++s) x = fmaf(a[t * (L + 1) + s], vs[s * P + e], x);
#pragma unroll 8
      for (int j = 0; j < K; ++j) x = fmaf(rs[t * P + j], st[j * K + e], x);
      out[off + i] = x;
    }
    __syncthreads();  // every read of the old state is done

    // S[j][e] = exp(Lambda_{L-1}[j]) S[j][e] + sum_s k'[s][j] v[s][e]
    for (int i = tid; i < K * K; i += kThreads) {
      const int j = i / K, e = i % K;
      float inj = 0.f;
#pragma unroll 8
      for (int s = 0; s < L; ++s) inj = fmaf(ks[s * P + j], vs[s * P + e], inj);
      st[i] = expf(last[j]) * st[i] + inj;
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<int64_t>(blockIdx.x) * K * K;
  for (int i = tid; i < K * K; i += kThreads) so[i] = st[i];
}

struct Args {
  const float *r, *k, *v, *wlog, *u;
  float *out, *state;
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
  kernel<<<a.bh, kThreads, C::kBytes, a.stream>>>(a.r, a.k, a.v, a.wlog, a.u, a.out, a.state,
                                                   a.seq);
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

// r, k, v, wlog, out: (bh, seq, K) f32; u: (K,); state: (bh, K, K), the
// final state.  Returns cudaGetLastError() after the launch (0 on success);
// argument errors return cudaErrorInvalidValue.
int wkv_launch(int chunk, int K, const float* r, const float* k, const float* v,
               const float* wlog, const float* u, float* out, float* state, int bh, int seq,
               void* stream) {
  if (bh < 1 || chunk < 1 || seq % chunk) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, wlog, u, out, state, bh, seq, static_cast<cudaStream_t>(stream)};
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
