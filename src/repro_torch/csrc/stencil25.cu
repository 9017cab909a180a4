// Range-r 3D star stencil (paper §IV.C, 25 points at r = 4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_stencil_kernel` / `stencil25_pallas` in
// src/repro/kernels/stencil25/kernel.py.  That kernel tiles (z, y) with nine
// overlapping BlockSpecs.  Both kernels here keep the thread->cell map that
// the paper's GPU estimator models (`repro_torch.core.appspec.star3d_ir`,
// `frontend/ir.py::fold_ir`), so the estimator's (block, fold) choice is what
// runs:
//
//   * one thread per fold group, thread t = blockIdx * blockDim + threadIdx in
//     (x, y, z) order, x fastest;
//   * it updates the cells g = fold * t + j, j in [0, fold) (x fastest);
//   * the launch grid is ceil(grid / fold / block); ragged blocks are masked.
//
// The halo is edge-clamped on all three axes, so the result equals the plain
// version (`stencil25_plain`, like `stencil25_ref`) everywhere.
//
// Bound on the H100: device-memory bytes.  The compulsory traffic is one read
// of src and one write of dst (16 B per cell in f64) against 49 flops per
// cell.  The 6r neighbour loads per cell beyond the centre have to come from
// on-chip memory; how much device and L2 traffic the block's footprint costs
// depends on the block shape, which is what the estimator ranks.
//
// Two kernels, one source:
//
//   stencil25_staged_kernel (the main path, `stencil25_cuda`).  Block b first
//     copies its star footprint into dynamic shared memory, once: each row
//     of the footprint that lies inside the grid goes as one bulk copy
//     (cp.async.bulk, the copy engine's, which takes no issue slots from the
//     SM while it runs), completing on one mbarrier; a row that the grid's
//     edge clamps goes element by element with cp.async (8 B in f64, 4 B in
//     f32; bf16 by plain loads and stores), the clamp on the source index.
//     Then every thread reads its 6r + 1 points from shared memory, with
//     32-bit indices and no clamps.  Where the fold is (1, 2, 1)
//     or (1, 1, 2) the two cells of a thread share a column, and each value
//     that both read is read once: per distance d, cell 0's +d neighbour
//     along the fold axis is cell 1's d - 1 one, and cell 1's -d neighbour
//     cell 0's d - 1 one.  This is the estimator's case with no L1 capacity
//     misses (v_l2l1_load_cap = 0): every element of the footprint crosses
//     from L2 once per block.  The footprint of cell box C = block * fold is
//     three boxes, x fastest in each (`Footprint` below):
//       X  (Cx + 2r) x Cy x Cz   the cells and their x-arms;
//       Y  Cx x 2r x Cz          the y-arms: slot s < r holds row y0 - r + s,
//                                slot s >= r row y0 + Cy - r + s;
//       Z  Cx x Cy x 2r          the z-arms, the same way in z.
//     (Cx Cy Cz + 2r (Cy Cz + Cx Cz + Cx Cy)) elements: 60 KB in f64 for the
//     estimator's pick at the paper's grid, at most 208 KB over the paper's
//     162 configurations.  The wrapper computes the same count, allows the
//     largest dynamic shared memory once per instantiation, and passes the
//     bytes at launch; the launch refuses a count that disagrees.
//     What this costs: a block computes only once its whole footprint has
//     landed, and its reads of shared memory (21 values per cell at fold
//     (1, 2, 1)) then take about as long as the copy.  Two 1024-thread blocks
//     share an SM, so one block's copy runs under the other's compute only
//     as far as their phases differ; bulk copies leave the SM's load/store
//     pipe to that compute, where per-element cp.async competes with it, and
//     copy groups that the lower slabs of a block compute from first leave
//     too few warps computing at a time.  benchmarks/torch_stencil_probe.py
//     times each part on the card.
//
//   stencil25_direct_kernel (the port's first kernel, off the main path).  The literal
//     kernel of `star3d_ir`, load for load: every point is a direct global
//     load with clamped 64-bit indices, and neighbouring threads and blocks
//     share data through L1 and L2 only.  Kept to time against the staged
//     kernel over one ranking.
//
// Both sum the same 6r + 1 products in the same order (centre, then for
// d = 1..r: +x, -x, +y, -y, +z, -z), so they agree to the last bit.  Types:
// f64, f32, and bf16 (loads and stores bf16, accumulates in f32).  Weight k
// belongs to star offset k of `star_offsets(r)`.  Every block of the paper's
// space has 1024 threads.  The direct kernel is bound to 1024 threads (up to
// 64 registers; it takes 32), the staged one to two such blocks per SM (32
// registers): with one block per SM, an SM would wait for each block's copy
// with nothing to compute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRange = 8;
constexpr int kMaxPoints = 6 * kMaxRange + 1;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may have

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
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---- PTX: cp.async, bulk copies and mbarriers ---------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// that completes its bytes on the mbarrier `bar` when it lands.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An mbarrier in shared memory whose first phase completes after `count`
// arrivals and once the bytes they expect have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised mbarrier visible to the bulk copies.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on `bar` that also expects `bytes` more of bulk copies.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared.b64 state, [%0], %1;\n}\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Holds `bar`'s phase open until every cp.async that this thread issued
// before has landed.
__device__ __forceinline__ void mbar_track_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the first phase of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) { return __reduce_add_sync(__activemask(), v); }

__device__ __forceinline__ void copy_elem(double* dst, const double* src) { cp_async8(dst, src); }
__device__ __forceinline__ void copy_elem(float* dst, const float* src) { cp_async4(dst, src); }
// no 2-byte cp.async exists
__device__ __forceinline__ void copy_elem(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = __ldg(src);
}

// ---- the direct kernel ---------------------------------------------------------

template <typename T, int FX, int FY, int FZ>
__global__ void __launch_bounds__(1024)
    stencil25_direct_kernel(const T* __restrict__ src, T* __restrict__ dst, int nx, int ny,
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

// ---- the staged kernel ---------------------------------------------------------

// A block's star footprint in shared memory, in elements (see the note at
// the top): the X box, then the Y arms, then the Z arms.
struct Footprint {
  int cx, cy, cz, r;
  int pitch, plane;  // a row and a plane of the X box
  int n_x, n_y, n_z;
  __host__ __device__ Footprint(int cx_, int cy_, int cz_, int r_)
      : cx(cx_), cy(cy_), cz(cz_), r(r_), pitch(cx_ + 2 * r_), plane((cx_ + 2 * r_) * cy_),
        n_x((cx_ + 2 * r_) * cy_ * cz_), n_y(cx_ * 2 * r_ * cz_), n_z(cx_ * cy_ * 2 * r_) {}
  __host__ __device__ int64_t elements() const {
    return static_cast<int64_t>(n_x) + n_y + n_z;
  }
};

__device__ __forceinline__ int clamp_to(int v, int n) { return min(max(v, 0), n - 1); }

// Copies one row of a box into s: w elements of grid row (gz, gy) from x =
// gx0 on.  A bulk copy where the row lies inside the grid and both its ends
// are 16-byte aligned; else element by element, x clamped to the grid, with
// cp.async (plain loads and stores in bf16) that hold `bar` open until they
// land.  Returns the bytes of bulk copy it issued.
template <typename T>
__device__ __forceinline__ unsigned copy_row(T* s, const T* __restrict__ src, int nx, int ny, int gz,
                                             int gy, int gx0, int w, uint64_t* bar) {
  const T* row = src + (static_cast<int64_t>(gz) * ny + gy) * nx;
  const unsigned bytes = w * sizeof(T);
  if (gx0 >= 0 && gx0 + w <= nx && bytes % 16 == 0 &&
      reinterpret_cast<uintptr_t>(row + gx0) % 16 == 0 && smem_addr(s) % 16 == 0) {
    bulk_copy(s, row + gx0, bytes, bar);
    return bytes;
  }
  for (int x = 0; x < w; ++x) copy_elem(s + x, row + clamp_to(gx0 + x, nx));
  mbar_track_copies(bar);
  return 0;
}

// Where one cell's neighbours lie in the footprint.  The neighbour d rows
// above the cell is in the X box while d <= up_y, else in the upper y-arm at
// yhi + d * cx; d rows below, in the X box while d <= below_y, else at
// ylo - d * cx.  Likewise in z, with a plane of the arms cx * cy apart.
struct Cell {
  int c;  // the cell in the X box
  int up_y, below_y, up_z, below_z;
  int yhi, ylo, zhi, zlo;
  __device__ Cell(const Footprint& f, int lx, int ly, int lz)
      : c((lz * f.cy + ly) * f.pitch + lx + f.r),
        up_y(f.cy - 1 - ly), below_y(ly), up_z(f.cz - 1 - lz), below_z(lz),
        yhi(f.n_x + (lz * 2 * f.r + ly - f.cy + f.r) * f.cx + lx),
        ylo(f.n_x + (lz * 2 * f.r + ly + f.r) * f.cx + lx),
        zhi(f.n_x + f.n_y + ((lz - f.cz + f.r) * f.cy + ly) * f.cx + lx),
        zlo(f.n_x + f.n_y + ((lz + f.r) * f.cy + ly) * f.cx + lx) {}
  __device__ int y(const Footprint& f, int d) const {  // d != 0, a compile-time constant
    if (d > 0) return d <= up_y ? c + d * f.pitch : yhi + d * f.cx;
    return -d <= below_y ? c + d * f.pitch : ylo + d * f.cx;
  }
  __device__ int z(const Footprint& f, int d) const {
    if (d > 0) return d <= up_z ? c + d * f.plane : zhi + d * f.cx * f.cy;
    return -d <= below_z ? c + d * f.plane : zlo + d * f.cx * f.cy;
  }
};

// The cells of thread (tx, ty, tz) from the footprint in shared memory.
template <typename T, int FY, int FZ>
__device__ __forceinline__ void stencil_cells(const T* box, const Footprint& f, T* __restrict__ dst,
                                              int nx, int ny, int tx, int ty, int tz,
                                              const StarWeights& wts) {
  using A = typename Acc<T>::type;
  constexpr int NC = FY * FZ;  // cells per thread, stacked along the fold axis
  const int r = f.r;
  const int lx = threadIdx.x, ly = threadIdx.y * FY, lz = threadIdx.z * FZ;
  const Cell cells[2] = {Cell(f, lx, ly, lz), Cell(f, lx, ly + FY - 1, lz + FZ - 1)};
  A acc[NC];
  // lo: cell 0's neighbour d - 1 below it along the fold axis; hi: cell 1's
  // neighbour d - 1 above it.  At d = 1 these are the two cells themselves.
  T lo = box[cells[0].c], hi = box[cells[NC - 1].c];
  acc[0] = static_cast<A>(wts.w[0]) * to_acc(lo);
  if (NC == 2) acc[NC - 1] = static_cast<A>(wts.w[0]) * to_acc(hi);
#pragma unroll
  for (int d = 1; d <= kMaxRange; ++d) {
    if (d > r) break;
    const int k = 6 * d - 5;  // weight of the +x neighbour at distance d
    T next_lo = lo, next_hi = hi;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const Cell& q = cells[j];
      T yp, ym, zp, zm;
      if (FY == 2 && j == 0) {
        yp = hi;
        ym = next_lo = box[q.y(f, -d)];
      } else if (FY == 2) {
        yp = next_hi = box[q.y(f, d)];
        ym = lo;
      } else {
        yp = box[q.y(f, d)];
        ym = box[q.y(f, -d)];
      }
      if (FZ == 2 && j == 0) {
        zp = hi;
        zm = next_lo = box[q.z(f, -d)];
      } else if (FZ == 2) {
        zp = next_hi = box[q.z(f, d)];
        zm = lo;
      } else {
        zp = box[q.z(f, d)];
        zm = box[q.z(f, -d)];
      }
      acc[j] += static_cast<A>(wts.w[k + 0]) * to_acc(box[q.c + d]);
      acc[j] += static_cast<A>(wts.w[k + 1]) * to_acc(box[q.c - d]);
      acc[j] += static_cast<A>(wts.w[k + 2]) * to_acc(yp);
      acc[j] += static_cast<A>(wts.w[k + 3]) * to_acc(ym);
      acc[j] += static_cast<A>(wts.w[k + 4]) * to_acc(zp);
      acc[j] += static_cast<A>(wts.w[k + 5]) * to_acc(zm);
    }
    lo = next_lo;
    hi = next_hi;
  }
  const int64_t sy = nx, sz = static_cast<int64_t>(nx) * ny;
  const int x = tx, y = FY * ty, z = FZ * tz;
  store(dst + z * sz + y * sy + x, acc[0]);
  if (NC == 2) store(dst + (z + FZ - 1) * sz + (y + FY - 1) * sy + x, acc[NC - 1]);
}

template <typename T, int FY, int FZ>
__global__ void __launch_bounds__(1024, 2)
    stencil25_staged_kernel(const T* __restrict__ src, T* __restrict__ dst, int nx, int ny,
                            int nz, int r, StarWeights wts) {
  static_assert(FY * FZ <= 2 && FY >= 1 && FZ >= 1, "folds (1,1,1), (1,2,1), (1,1,2)");
  extern __shared__ __align__(16) unsigned char staged_smem[];
  __shared__ uint64_t landed;  // the footprint is in shared memory
  T* const box = reinterpret_cast<T*>(staged_smem);
  const Footprint f(blockDim.x, blockDim.y * FY, blockDim.z * FZ, r);
  const int x0 = blockIdx.x * f.cx, y0 = blockIdx.y * f.cy, z0 = blockIdx.z * f.cz;
  const int nthreads = blockDim.x * blockDim.y * blockDim.z;
  const int tid = threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  if (tid == 0) {
    mbar_init(&landed, (nthreads + 31) / 32);
    fence_barrier_init();
  }
  __syncthreads();

  // Copy in: the rows of the X box, the Y arms and the Z arms are dealt to
  // the threads, one row a thread (also those whose cells are masked); each
  // warp then arrives once, expecting the bytes of bulk copy it issued.
  const int x_rows = f.cy * f.cz, y_rows = 2 * r * f.cz, z_rows = f.cy * 2 * r;
  unsigned issued = 0;
  for (int q = tid; q < x_rows + y_rows + z_rows; q += nthreads) {
    if (q < x_rows) {
      const int z = q / f.cy, y = q - z * f.cy;
      issued += copy_row(box + (z * f.cy + y) * f.pitch, src, nx, ny, clamp_to(z0 + z, nz),
                         clamp_to(y0 + y, ny), x0 - r, f.pitch, &landed);
    } else if (q < x_rows + y_rows) {  // slot y < r: row y0 - r + y; else y0 + Cy - r + y
      const int k = q - x_rows, z = k / (2 * r), y = k - z * 2 * r;
      issued += copy_row(box + f.n_x + k * f.cx, src, nx, ny, clamp_to(z0 + z, nz),
                         clamp_to(y0 - r + y + (y >= r ? f.cy : 0), ny), x0, f.cx, &landed);
    } else {  // likewise in z
      const int k = q - x_rows - y_rows, z = k / f.cy, y = k - z * f.cy;
      issued += copy_row(box + f.n_x + f.n_y + k * f.cx, src, nx, ny,
                         clamp_to(z0 - r + z + (z >= r ? f.cz : 0), nz), clamp_to(y0 + y, ny), x0,
                         f.cx, &landed);
    }
  }
  issued = warp_sum(issued);
  __syncwarp();
  if (tid % 32 == 0) mbar_arrive_expect(&landed, issued);
  mbar_wait(&landed);

  const int tx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ty = blockIdx.y * blockDim.y + threadIdx.y;
  const int tz = blockIdx.z * blockDim.z + threadIdx.z;
  if (tx >= nx || ty >= ny / FY || tz >= nz / FZ) return;
  stencil_cells<T, FY, FZ>(box, f, dst, nx, ny, tx, ty, tz, wts);
}

// ---- launches ------------------------------------------------------------------

// Calls F<T, FY, FZ>(args...) for the compiled folds (fold x is 1).
#define STENCIL_FOLDS(F, T, FX_, FY_, FZ_, ...)                            \
  if ((FX_) == 1 && (FY_) == 1 && (FZ_) == 1) return F<T, 1, 1>(__VA_ARGS__); \
  if ((FX_) == 1 && (FY_) == 2 && (FZ_) == 1) return F<T, 2, 1>(__VA_ARGS__); \
  if ((FX_) == 1 && (FY_) == 1 && (FZ_) == 2) return F<T, 1, 2>(__VA_ARGS__); \
  return static_cast<int>(cudaErrorInvalidValue);

#define STENCIL_TYPES(F, DTYPE, ...)                                      \
  switch (DTYPE) {                                                        \
    case 0: return F<double>(__VA_ARGS__);                                \
    case 1: return F<float>(__VA_ARGS__);                                 \
    case 2: return F<__nv_bfloat16>(__VA_ARGS__);                         \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

struct Launch {
  const void* src;
  void* dst;
  int nx, ny, nz, r;
  StarWeights wts;
  dim3 block;
  int fx, fy, fz;
  int smem_bytes;  // staged kernel only
  cudaStream_t stream;
  dim3 grid() const {
    return dim3((nx / fx + block.x - 1) / block.x, (ny / fy + block.y - 1) / block.y,
                (nz / fz + block.z - 1) / block.z);
  }
};

template <typename T, int FY, int FZ>
int direct_fold(const Launch& a) {
  stencil25_direct_kernel<T, 1, FY, FZ><<<a.grid(), a.block, 0, a.stream>>>(
      static_cast<const T*>(a.src), static_cast<T*>(a.dst), a.nx, a.ny, a.nz, a.r, a.wts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FY, int FZ>
int staged_fold(const Launch& a) {
  stencil25_staged_kernel<T, FY, FZ><<<a.grid(), a.block, a.smem_bytes, a.stream>>>(
      static_cast<const T*>(a.src), static_cast<T*>(a.dst), a.nx, a.ny, a.nz, a.r, a.wts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int direct_typed(const Launch& a) {
  STENCIL_FOLDS(direct_fold, T, a.fx, a.fy, a.fz, a)
}

template <typename T>
int staged_typed(const Launch& a) {
  STENCIL_FOLDS(staged_fold, T, a.fx, a.fy, a.fz, a)
}

template <typename T, int FY, int FZ>
const void* kernel_fn(int staged) {
  return staged ? reinterpret_cast<const void*>(stencil25_staged_kernel<T, FY, FZ>)
                : reinterpret_cast<const void*>(stencil25_direct_kernel<T, 1, FY, FZ>);
}

template <typename T, int FY, int FZ>
int attrs_fold(int staged, cudaFuncAttributes* a) {
  return static_cast<int>(cudaFuncGetAttributes(a, kernel_fn<T, FY, FZ>(staged)));
}

template <typename T>
int attrs_typed(int staged, int fx, int fy, int fz, cudaFuncAttributes* a) {
  STENCIL_FOLDS(attrs_fold, T, fx, fy, fz, staged, a)
}

// The block's shared memory is `bytes` in all: the dynamic part is what the
// kernel's static mbarrier leaves.
template <typename T, int FY, int FZ>
int allow_fold(int bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel_fn<T, FY, FZ>(1));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel_fn<T, FY, FZ>(1), cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes - static_cast<int>(a.sharedSizeBytes)));
}

template <typename T>
int allow_typed(int fx, int fy, int fz, int bytes) {
  STENCIL_FOLDS(allow_fold, T, fx, fy, fz, bytes)
}

template <typename T, int FY, int FZ>
int occupancy_fold(int threads, int bytes, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_fn<T, FY, FZ>(1), threads, bytes));
}

template <typename T>
int occupancy_typed(int fx, int fy, int fz, int threads, int bytes, int* blocks) {
  STENCIL_FOLDS(occupancy_fold, T, fx, fy, fz, threads, bytes, blocks)
}

int element_size(int dtype) { return dtype == 0 ? 8 : dtype == 1 ? 4 : 2; }

bool make_launch(Launch* a, int dtype, const void* src, void* dst, int nx, int ny, int nz, int r,
                 const double* weights, int bx, int by, int bz, int fx, int fy, int fz,
                 void* stream) {
  if (r < 1 || r > kMaxRange || dtype < 0 || dtype > 2) return false;
  a->src = src;
  a->dst = dst;
  a->nx = nx;
  a->ny = ny;
  a->nz = nz;
  a->r = r;
  for (int k = 0; k < kMaxPoints; ++k) a->wts.w[k] = k < 6 * r + 1 ? weights[k] : 0.0;
  a->block = dim3(bx, by, bz);
  a->fx = fx;
  a->fy = fy;
  a->fz = fz;
  a->smem_bytes = 0;
  a->stream = static_cast<cudaStream_t>(stream);
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = f64, 1 = f32, 2 = bf16.  Each launch returns cudaGetLastError()
// after the launch (0 on success); argument errors return
// cudaErrorInvalidValue.

// The staged kernel.  smem_bytes must be the block's footprint in bytes,
// (Cx Cy Cz + 2r (Cy Cz + Cx Cz + Cx Cy)) * element size with C = block * fold.
int stencil25_launch(int dtype, const void* src, void* dst, int nx, int ny, int nz, int r,
                     const double* weights, int bx, int by, int bz, int fx, int fy, int fz,
                     int smem_bytes, void* stream) {
  Launch a;
  if (!make_launch(&a, dtype, src, dst, nx, ny, nz, r, weights, bx, by, bz, fx, fy, fz, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const Footprint f(bx * fx, by * fy, bz * fz, r);
  if (f.elements() * element_size(dtype) != smem_bytes || smem_bytes > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  a.smem_bytes = smem_bytes;
  STENCIL_TYPES(staged_typed, dtype, a)
}

// The direct kernel, for comparison only.
int stencil25_direct_launch(int dtype, const void* src, void* dst, int nx, int ny, int nz, int r,
                            const double* weights, int bx, int by, int bz, int fx, int fy, int fz,
                            void* stream) {
  Launch a;
  if (!make_launch(&a, dtype, src, dst, nx, ny, nz, r, weights, bx, by, bz, fx, fy, fz, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  STENCIL_TYPES(direct_typed, dtype, a)
}

// Allows the staged instantiation (dtype, fold) up to `bytes` of shared
// memory a block, its static mbarrier included; returns the CUDA error.
int stencil25_allow_smem(int dtype, int fx, int fy, int fz, int bytes) {
  STENCIL_TYPES(allow_typed, dtype, fx, fy, fz, bytes)
}

// Blocks of `threads` threads with `bytes` of dynamic shared memory that one
// SM of this card holds at once, for the staged instantiation (dtype, fold).
int stencil25_occupancy(int dtype, int fx, int fy, int fz, int threads, int bytes,
                        int* blocks) {
  STENCIL_TYPES(occupancy_typed, dtype, fx, fy, fz, threads, bytes, blocks)
}

// Registers per thread, local (spill) bytes per thread and the largest block
// of the compiled instantiation; staged = 1 for the staged kernel, 0 for the
// direct one.
int stencil25_attributes(int staged, int dtype, int fx, int fy, int fz, int* regs,
                         int* local_bytes, int* max_threads) {
  cudaFuncAttributes a;
  int err;
  switch (dtype) {
    case 0: err = attrs_typed<double>(staged, fx, fy, fz, &a); break;
    case 1: err = attrs_typed<float>(staged, fx, fy, fz, &a); break;
    case 2: err = attrs_typed<__nv_bfloat16>(staged, fx, fy, fz, &a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
