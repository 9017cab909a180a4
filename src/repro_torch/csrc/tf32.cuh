// Building blocks shared by the WKV kernels (wkv.cu, wkv_bwd.cu): cp.async
// copies, f32 products on the tensor cores in 3xTF32, and a warp
// reduce-scatter.  Included by each source inside its own translation unit:
// everything here lives in an anonymous namespace.
//
// 3xTF32: mma.sync.m16n8k8 takes TF32 operands (10 bits of mantissa, a
// relative rounding of about 4.9e-4) and accumulates in f32.  Each operand x
// is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and the product is
// accumulated as x_lo y_hi + x_hi y_lo + x_hi y_hi, which leaves out only
// x_lo y_lo, about 2^-22 of the product.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NH = 2;  // the 8-column halves of a 16 x 16 tensor-core tile

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 bits of mantissa, to nearest, ties away)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// d += a b for a 16 x 8 tile, TF32 in, f32 accumulate.  Fragments (g = lane
// / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8,
// q + 4); b0 (q, g), b1 (q + 4, g); d0, d1 (g, 2q + {0, 1}), d2, d3 (g + 8,
// 2q + {0, 1}).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += A B for a 16 x 16 tile, A(m, k) and B(k, n) read through the given
// functions, k < KD, in 3xTF32.  c[h] is the 16 x 8 tile of columns 8h ..
// 8h + 7, in mma_tf32's fragment layout.
template <int KD, class FA, class FB>
__device__ __forceinline__ void mma_tile(float (&c)[NH][4], FA a_at, FB b_at, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < KD; k0 += 8) {
    uint32_t ah[4], al[4], bh[NH][2], bl[NH][2];
    split_tf32(a_at(g, k0 + q), ah[0], al[0]);
    split_tf32(a_at(g + 8, k0 + q), ah[1], al[1]);
    split_tf32(a_at(g, k0 + q + 4), ah[2], al[2]);
    split_tf32(a_at(g + 8, k0 + q + 4), ah[3], al[3]);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      split_tf32(b_at(k0 + q, 8 * h + g), bh[h][0], bl[h][0]);
      split_tf32(b_at(k0 + q + 4, 8 * h + g), bh[h][1], bl[h][1]);
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) mma_tf32(c[h], al, bh[h]);
#pragma unroll
    for (int h = 0; h < NH; ++h) mma_tf32(c[h], ah, bl[h]);
#pragma unroll
    for (int h = 0; h < NH; ++h) mma_tf32(c[h], ah, bh[h]);
  }
}

// Calls put(row, col, value) for every entry of a 16 x 16 tile held as
// mma_tile's c.
template <class F>
__device__ __forceinline__ void tile_out(const float (&c)[NH][4], int lane, F put) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    put(g, 8 * h + 2 * q, c[h][0]);
    put(g, 8 * h + 2 * q + 1, c[h][1]);
    put(g + 8, 8 * h + 2 * q, c[h][2]);
    put(g + 8, 8 * h + 2 * q + 1, c[h][3]);
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

}  // namespace
