// One D3Q15 conservative Allen-Cahn interface-tracking LB step (paper §IV.D)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lbm_kernel` / `lbm_step_pallas` in
// src/repro/kernels/lbm_d3q15/kernel.py.  That kernel tiles (z, y) with 3x3
// overlapping BlockSpecs; this one is the kernel the paper's GPU estimator
// models (`repro_torch.core.appspec.lbm_d3q15_ir`): one thread per lattice
// cell, thread (x, y, z) = blockIdx * blockDim + threadIdx with x fastest,
// direct global loads and no shared-memory tiling.  Ragged blocks are masked.
//
// Per cell it
//   * pull-streams the 15 pdfs: f_q(p) <- f_q(p - c_q), c = (cx, cy, cz);
//   * computes phi = sum_q f_q;
//   * takes the 7-point central-difference gradient of the *input* phase and
//     normalises it with 1 / sqrt(|grad|^2 + 1e-12);
//   * applies the sharpening term 4 phi (1 - phi) / width;
//   * BGK-relaxes with 1/tau toward w_q phi (1 + 3 c.u), adding the forcing
//     w_q sharp (c.n);
//   * stores the 15 pdfs and phi.
// All three axes are periodic, so the result equals the plain version
// (`lbm_step_plain`, like `lbm_step_ref`) everywhere.
//
// Layouts: f and f_out are SoA (15, nz, ny, nx), phase (nz, ny, nx), vel
// (3, nz, ny, nx), all contiguous.
//
// Bound on the H100: device-memory bytes.  Each cell reads 15 pdfs, one phase
// value and three velocities and writes 16 values (280 B in f64) against
// about 350 flops.  The six neighbour phase loads and the shifted pdf loads
// must hit L1/L2, which the block shape decides.  The estimator assumes at
// most 128 registers per thread, so blocks hold 512 threads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ double inv_sqrt(double v) { return 1.0 / sqrt(v); }
__device__ __forceinline__ float inv_sqrt(float v) { return 1.0f / sqrtf(v); }

template <typename T>
__global__ void __launch_bounds__(512)
    lbm_d3q15_kernel(const T* __restrict__ f, const T* __restrict__ phase,
                     const T* __restrict__ vel, T* __restrict__ f_out,
                     T* __restrict__ phase_out, int nx, int ny, int nz, T inv_tau,
                     T width) {
  // D3Q15 velocities (cx, cy, cz) and weights, in the order of `DIRS`.
  constexpr int CX[15] = {0, 1, -1, 0, 0, 0, 0, 1, 1, 1, 1, -1, -1, -1, -1};
  constexpr int CY[15] = {0, 0, 0, 1, -1, 0, 0, 1, 1, -1, -1, 1, 1, -1, -1};
  constexpr int CZ[15] = {0, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1, 1, -1};
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z * blockDim.z + threadIdx.z;
  if (x >= nx || y >= ny || z >= nz) return;
  const int64_t sy = nx;
  const int64_t sz = static_cast<int64_t>(nx) * ny;
  const int64_t n = sz * nz;
  const int64_t p = z * sz + y * sy + x;

  T pulled[15];
  T phi = T(0);
#pragma unroll
  for (int q = 0; q < 15; ++q) {
    const int64_t src = wrap(z - CZ[q], nz) * sz + wrap(y - CY[q], ny) * sy +
                        wrap(x - CX[q], nx);
    pulled[q] = __ldg(f + q * n + src);
    phi = q == 0 ? pulled[0] : phi + pulled[q];
  }

  const int64_t xp = z * sz + y * sy + wrap(x + 1, nx);
  const int64_t xm = z * sz + y * sy + wrap(x - 1, nx);
  const int64_t yp = z * sz + wrap(y + 1, ny) * sy + x;
  const int64_t ym = z * sz + wrap(y - 1, ny) * sy + x;
  const int64_t zp = wrap(z + 1, nz) * sz + y * sy + x;
  const int64_t zm = wrap(z - 1, nz) * sz + y * sy + x;
  const T gx = T(0.5) * (__ldg(phase + xp) - __ldg(phase + xm));
  const T gy = T(0.5) * (__ldg(phase + yp) - __ldg(phase + ym));
  const T gz = T(0.5) * (__ldg(phase + zp) - __ldg(phase + zm));
  const T inv_norm = inv_sqrt(gx * gx + gy * gy + gz * gz + T(1e-12));
  const T nxv = gx * inv_norm, nyv = gy * inv_norm, nzv = gz * inv_norm;
  const T sharp = (T(4.0) * phi * (T(1.0) - phi)) / width;
  const T ux = __ldg(vel + p), uy = __ldg(vel + n + p), uz = __ldg(vel + 2 * n + p);

#pragma unroll
  for (int q = 0; q < 15; ++q) {
    const T w = q == 0 ? T(2.0 / 9.0) : (q < 7 ? T(1.0 / 9.0) : T(1.0 / 72.0));
    const T cx = T(CX[q]), cy = T(CY[q]), cz = T(CZ[q]);
    const T cu = T(3.0) * (cx * ux + cy * uy + cz * uz);
    const T heq = w * phi * (T(1.0) + cu);
    const T forcing = w * sharp * (cx * nxv + cy * nyv + cz * nzv);
    f_out[q * n + p] = pulled[q] - inv_tau * (pulled[q] - heq) + forcing;
  }
  phase_out[p] = phi;
}

template <typename T>
int launch_typed(const void* f, const void* phase, const void* vel, void* f_out,
                 void* phase_out, int nx, int ny, int nz, double tau, double width,
                 dim3 block, cudaStream_t stream) {
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  (nz + block.z - 1) / block.z);
  lbm_d3q15_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const T*>(phase), static_cast<const T*>(vel),
      static_cast<T*>(f_out), static_cast<T*>(phase_out), nx, ny, nz,
      static_cast<T>(1.0 / tau), static_cast<T>(width));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = f64, 1 = f32.  Returns cudaGetLastError() after the launch.
int lbm_d3q15_launch(int dtype, const void* f, const void* phase, const void* vel,
                     void* f_out, void* phase_out, int nx, int ny, int nz, double tau,
                     double width, int bx, int by, int bz, void* stream) {
  const dim3 block(bx, by, bz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_typed<double>(f, phase, vel, f_out, phase_out, nx, ny, nz, tau,
                                  width, block, s);
    case 1:
      return launch_typed<float>(f, phase, vel, f_out, phase_out, nx, ny, nz, tau,
                                 width, block, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, local (spill) bytes per thread and the largest block
// the compiled instantiation can launch.
int lbm_d3q15_attributes(int dtype, int* regs, int* local_bytes, int* max_threads) {
  cudaFuncAttributes a;
  int err;
  switch (dtype) {
    case 0: err = static_cast<int>(cudaFuncGetAttributes(&a, lbm_d3q15_kernel<double>)); break;
    case 1: err = static_cast<int>(cudaFuncGetAttributes(&a, lbm_d3q15_kernel<float>)); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

// Blocks of `threads` threads of the compiled instantiation that one SM of
// the current card holds at once (no shared memory).
int lbm_d3q15_occupancy(int dtype, int threads, int* blocks) {
  switch (dtype) {
    case 0:
      return static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lbm_d3q15_kernel<double>, threads, 0));
    case 1:
      return static_cast<int>(
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lbm_d3q15_kernel<float>, threads, 0));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
