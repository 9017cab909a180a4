// Range-r 3D star stencil (paper §IV.C, 25 points at r = 4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_stencil_kernel` / `stencil25_pallas` in
// src/repro/kernels/stencil25/kernel.py.  That kernel tiles (z, y) with nine
// overlapping BlockSpecs; this one is the kernel the paper's GPU estimator
// models (`repro_torch.core.appspec.star3d_ir`, `frontend/ir.py::fold_ir`):
//
//   * one thread per fold group, thread t = blockIdx * blockDim + threadIdx in
//     (x, y, z) order, x fastest;
//   * it updates the cells g = fold * t + j, j in [0, fold) (x fastest);
//   * every point is a direct global load, with no shared-memory tiling, so
//     neighbouring threads and blocks share data through L1 and L2 only;
//   * the launch grid is ceil(grid / fold / block); ragged blocks are masked.
//
// The halo is edge-clamped on all three axes, so the result equals the plain
// version (`stencil25_plain`, like `stencil25_ref`) everywhere.
//
// Bound on the H100: device-memory bytes.  The compulsory traffic is one read
// of src and one write of dst (16 B per cell in f64) against 49 flops per
// cell; the 6r redundant neighbour loads per cell must hit L1/L2.  How well
// they do depends on the block shape, which is what the estimator ranks.
//
// Types: f64, f32, and bf16 (loads and stores bf16, accumulates in f32).
// Weight k belongs to star offset k of `star_offsets(r)`: centre, then for
// d = 1..r the six neighbours +x, -x, +y, -y, +z, -z.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRange = 8;
constexpr int kMaxPoints = 6 * kMaxRange + 1;

// The weights travel as a kernel parameter, so every thread reads them from
// the constant bank without touching device memory.
struct StarWeights {
  double w[kMaxPoints];
};

template <typename T>
struct Acc {
  using type = T;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int FX, int FY, int FZ>
__global__ void __launch_bounds__(1024)
    stencil25_kernel(const T* __restrict__ src, T* __restrict__ dst, int nx, int ny,
                     int nz, int r, StarWeights wts) {
  using A = typename Acc<T>::type;
  const int tx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ty = blockIdx.y * blockDim.y + threadIdx.y;
  const int tz = blockIdx.z * blockDim.z + threadIdx.z;
  if (tx >= nx / FX || ty >= ny / FY || tz >= nz / FZ) return;
  const int64_t sy = nx;
  const int64_t sz = static_cast<int64_t>(nx) * ny;
#pragma unroll
  for (int jz = 0; jz < FZ; ++jz) {
#pragma unroll
    for (int jy = 0; jy < FY; ++jy) {
#pragma unroll
      for (int jx = 0; jx < FX; ++jx) {
        const int x = FX * tx + jx;
        const int y = FY * ty + jy;
        const int z = FZ * tz + jz;
        const int64_t row = z * sz + y * sy;
        A acc = static_cast<A>(wts.w[0]) * load_acc(src + row + x);
        // Unrolled to the largest range so that every weight index is a
        // compile-time constant: the weights stay in the parameter bank.
#pragma unroll
        for (int d = 1; d <= kMaxRange; ++d) {
          if (d > r) break;
          const int k = 6 * d - 5;  // weight of the +x neighbour at distance d
          const int xp = min(x + d, nx - 1), xm = max(x - d, 0);
          const int yp = min(y + d, ny - 1), ym = max(y - d, 0);
          const int zp = min(z + d, nz - 1), zm = max(z - d, 0);
          const int64_t col = z * sz + x;
          const int64_t pln = y * sy + x;
          acc += static_cast<A>(wts.w[k + 0]) * load_acc(src + row + xp);
          acc += static_cast<A>(wts.w[k + 1]) * load_acc(src + row + xm);
          acc += static_cast<A>(wts.w[k + 2]) * load_acc(src + col + yp * sy);
          acc += static_cast<A>(wts.w[k + 3]) * load_acc(src + col + ym * sy);
          acc += static_cast<A>(wts.w[k + 4]) * load_acc(src + zp * sz + pln);
          acc += static_cast<A>(wts.w[k + 5]) * load_acc(src + zm * sz + pln);
        }
        store(dst + row + x, acc);
      }
    }
  }
}

template <typename T>
int launch_typed(const void* src, void* dst, int nx, int ny, int nz, int r,
                 const StarWeights& wts, dim3 block, int fx, int fy, int fz,
                 cudaStream_t stream) {
  const dim3 grid((nx / fx + block.x - 1) / block.x, (ny / fy + block.y - 1) / block.y,
                  (nz / fz + block.z - 1) / block.z);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(dst);
  if (fx == 1 && fy == 1 && fz == 1) {
    stencil25_kernel<T, 1, 1, 1><<<grid, block, 0, stream>>>(s, o, nx, ny, nz, r, wts);
  } else if (fx == 1 && fy == 2 && fz == 1) {
    stencil25_kernel<T, 1, 2, 1><<<grid, block, 0, stream>>>(s, o, nx, ny, nz, r, wts);
  } else if (fx == 1 && fy == 1 && fz == 2) {
    stencil25_kernel<T, 1, 1, 2><<<grid, block, 0, stream>>>(s, o, nx, ny, nz, r, wts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attrs_typed(int fx, int fy, int fz, cudaFuncAttributes* a) {
  if (fx == 1 && fy == 1 && fz == 1)
    return static_cast<int>(cudaFuncGetAttributes(a, stencil25_kernel<T, 1, 1, 1>));
  if (fx == 1 && fy == 2 && fz == 1)
    return static_cast<int>(cudaFuncGetAttributes(a, stencil25_kernel<T, 1, 2, 1>));
  if (fx == 1 && fy == 1 && fz == 2)
    return static_cast<int>(cudaFuncGetAttributes(a, stencil25_kernel<T, 1, 1, 2>));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = f64, 1 = f32, 2 = bf16.  Returns cudaGetLastError() after the
// launch (0 on success); argument errors return cudaErrorInvalidValue.
int stencil25_launch(int dtype, const void* src, void* dst, int nx, int ny, int nz,
                     int r, const double* weights, int bx, int by, int bz, int fx,
                     int fy, int fz, void* stream) {
  if (r < 1 || r > kMaxRange) return static_cast<int>(cudaErrorInvalidValue);
  StarWeights wts;
  for (int k = 0; k < kMaxPoints; ++k) wts.w[k] = k < 6 * r + 1 ? weights[k] : 0.0;
  const dim3 block(bx, by, bz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<double>(src, dst, nx, ny, nz, r, wts, block, fx, fy, fz, s);
    case 1:
      return launch_typed<float>(src, dst, nx, ny, nz, r, wts, block, fx, fy, fz, s);
    case 2:
      return launch_typed<__nv_bfloat16>(src, dst, nx, ny, nz, r, wts, block, fx, fy,
                                         fz, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, local (spill) bytes per thread and the largest block
// the compiled instantiation can launch.
int stencil25_attributes(int dtype, int fx, int fy, int fz, int* regs, int* local_bytes,
                         int* max_threads) {
  cudaFuncAttributes a;
  int err;
  switch (dtype) {
    case 0: err = attrs_typed<double>(fx, fy, fz, &a); break;
    case 1: err = attrs_typed<float>(fx, fy, fz, &a); break;
    case 2: err = attrs_typed<__nv_bfloat16>(fx, fy, fz, &a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
